from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, adamw, clip_by_global_norm, constant_schedule,
    cosine_schedule, get_optimizer, global_norm, sgd, warmup_cosine)
