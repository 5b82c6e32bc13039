from .schedule import DiffusionSchedule, linear_beta_schedule
from .process import (ddim_coefficients, ddim_time_grid, predict_x0_from_eps,
                      q_sample)
from .sampler import ddim_sample
from .dpm_solver import dpm_solver_coefficients, dpm_solver_pp_2m_sample
