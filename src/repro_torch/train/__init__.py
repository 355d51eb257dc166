"""The training loop of the port (the reference's ``repro.train``)."""
from .loop import TrainState, make_train_step, train_loop  # noqa: F401
