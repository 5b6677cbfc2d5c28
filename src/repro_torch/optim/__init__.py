from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state  # noqa: F401
