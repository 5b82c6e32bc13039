"""The port's tools, counterparts of the JAX package's `scripts/*.py` under
the same names, each run as a module on the card by default:

    python -m hybrid_diffusion_tpu_torch.scripts.eval_flagship --ckpt W.npz
    python -m hybrid_diffusion_tpu_torch.scripts.sweep_sampler --ckpt W.npz
    python -m hybrid_diffusion_tpu_torch.scripts.export_params --ckpt CK --out W.npz
    python -m hybrid_diffusion_tpu_torch.scripts.rescore_metrics --root R
    python -m hybrid_diffusion_tpu_torch.scripts.make_preview_grid --results R ...
    python -m hybrid_diffusion_tpu_torch.scripts.demo_e2e
    python -m hybrid_diffusion_tpu_torch.scripts.demo_staged
    python -m hybrid_diffusion_tpu_torch.scripts.demo_cfg
    python -m hybrid_diffusion_tpu_torch.scripts.regen_cfg_grids --params P.npz

`--device cpu` runs a tool that touches a model on the CPU. Importing a
tool does no work: each runs its `main()` under the `__main__` check.
"""
