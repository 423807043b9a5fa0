"""The port's train step (``steps.py``) and fault-tolerant train loop
(``train_loop.py``)."""
from repro_torch.train.steps import TrainState, build_train_step
from repro_torch.train.train_loop import LoopConfig, train
