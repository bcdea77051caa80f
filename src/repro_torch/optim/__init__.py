from repro_torch.optim.adamw import OptConfig, OptState, init, update, schedule, global_norm  # noqa: F401
