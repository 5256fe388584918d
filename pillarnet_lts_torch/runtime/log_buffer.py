"""Running-average metric buffer (the JAX package's
`runtime/log_buffer.py`, after the reference's `log_buffer.py`)."""

from collections import OrderedDict

import numpy as np


class LogBuffer:
    def __init__(self):
        self.val_history = OrderedDict()
        self.n_history = OrderedDict()
        self.output = OrderedDict()
        self.ready = False

    def clear_output(self):
        self.output.clear()
        self.ready = False

    def update(self, values, count=1):
        for key, var in values.items():
            self.val_history.setdefault(key, []).append(float(var))
            self.n_history.setdefault(key, []).append(count)

    def average(self, n=0):
        """Average the latest n values of each key, or all if n == 0."""
        for key in self.val_history:
            values = np.array(self.val_history[key][-n or None:])
            nums = np.array(self.n_history[key][-n or None:])
            self.output[key] = float((values * nums).sum() / nums.sum())
        self.ready = True
