from repro_torch.optim.adafactor import adafactor  # noqa: F401
from repro_torch.optim.optimizer import adamw, sgd_momentum  # noqa: F401
from repro_torch.optim.schedules import cosine_warmup  # noqa: F401
