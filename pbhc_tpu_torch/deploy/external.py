"""External stub policies for exercising deploy loops without a trained model
(counterpart of `pbhc_tpu/deploy/external.py`, a copy; reference
humanoidverse/deploy/external/core.py:8-50).

`zero` holds the default pose; `sin` waves selected joints sinusoidally.
Both expose the NumpyPolicy interface (callable obs -> action) plus the meta
dict the runtimes need, built from a robot config.
"""
from __future__ import annotations

import numpy as np


class _StubPolicy:
    def __init__(self, meta):
        self.meta = meta
        self.nd = meta["num_actions"]
        self.t = 0

    def __call__(self, obs):
        self.t += 1
        return self._action()


class ZeroPolicy(_StubPolicy):
    def _action(self):
        return np.zeros(self.nd, dtype=np.float32)


class SinPolicy(_StubPolicy):
    def __init__(self, meta, amp=0.3, freq_hz=0.5, joints=None):
        super().__init__(meta)
        self.amp = amp
        self.freq = freq_hz
        self.joints = joints if joints is not None else list(range(self.nd))

    def _action(self):
        a = np.zeros(self.nd, dtype=np.float32)
        phase = 2 * np.pi * self.freq * self.t * self.meta.get("dt", 0.02)
        a[self.joints] = self.amp * np.sin(phase)
        return a


def get_external_policy(kind, meta, **kw):
    return {"zero": ZeroPolicy, "sin": SinPolicy}[kind](meta, **kw)
