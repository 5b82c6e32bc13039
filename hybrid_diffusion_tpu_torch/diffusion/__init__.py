from .schedule import DiffusionSchedule, linear_beta_schedule
from .process import (ddim_coefficients, ddim_time_grid, ddpm_posterior_mean,
                      ddpm_sampling_variance, predict_x0_from_eps, q_sample)
from .sampler import ddim_sample, ddpm_sample, ddpm_step
from .dpm_solver import dpm_solver_coefficients, dpm_solver_pp_2m_sample
