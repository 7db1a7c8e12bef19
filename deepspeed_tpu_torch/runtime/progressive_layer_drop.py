"""Progressive layer drop (counterpart of
`deepspeed_tpu/runtime/progressive_layer_drop.py`).

The keep-probability schedule theta(t) = (1 - theta_bar) * exp(-gamma * t)
+ theta_bar. The engine reads it every step, draws the kept layers on the
host from it and hands them to the model as a batch leaf
(`runtime/engine.py`, `models/gpt.gpt_hidden(pld=...)`): only the kept
layers run. The JAX package's `pld_block_scan` (a Bernoulli mask inside a
layer scan) is called by nothing there and has no counterpart here.
"""

import numpy as np


class ProgressiveLayerDrop:
    def __init__(self, theta=0.5, gamma=0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step):
        self.current_theta = float(
            (1.0 - self.theta) * np.exp(-self.gamma * global_step)
            + self.theta)

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}
