"""int8 calibration state shared by the modules of the int8 deploy path.

The JAX package keeps each calibrated activation absmax in a separate
flax 'quant' collection and switches a module's core to int8 once the
collection holds its entry (`pillarnet_lts_tpu/models/backbones/base.py`
:632-736). Here the absmax is a buffer of the module, registered only when
the module is built with `quant=True`, and `calibrated` says whether it
holds a value: `runtime/quantize.py::calibrate` or
`runtime/convert.py::load_jax_variables` sets it.

While `observing` is on (`runtime/quantize.py::calibration_mode`) the
module runs its float path (f32 or bf16) and records the running max of
what it observes in `observed`; outside calibration nothing is observed.
"""

import torch


class Calibrated:
    """Mixin for an `nn.Module` with an int8 deploy mode. Call
    `_init_quant` from `__init__` after `nn.Module.__init__`."""

    def _init_quant(self, quant, name, shape, device):
        self.quant = bool(quant)
        self.absmax_name = name
        self.calibrated = False
        self.observing = False
        self.observed = None
        if self.quant:
            self.register_buffer(name, torch.zeros(shape, device=device))

    def quant_ready(self):
        """Run the int8 core: quant mode, calibrated, not calibrating."""
        return self.quant and self.calibrated and not self.observing

    def observe(self, amax):
        """Merge one observation (f32 absmax) into this batch's max."""
        self.observed = (amax if self.observed is None
                         else torch.maximum(self.observed, amax))

    def absmax(self):
        return getattr(self, self.absmax_name)

    @torch.no_grad()
    def set_absmax(self, value):
        self.absmax().copy_(value)
        self.calibrated = True
