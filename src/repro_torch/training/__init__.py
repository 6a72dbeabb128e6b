from repro_torch.training.train_step import TrainState, make_train_step  # noqa: F401
