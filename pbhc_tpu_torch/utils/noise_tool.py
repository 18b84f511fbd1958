"""Stochastic noise processes for observation corruption and deploy-time
robustness attacks (counterpart of `pbhc_tpu/utils/noise_tool.py`).

Two families, as there:
* numpy processes with internal state (`EmptyNoise`, `OUProcess`,
  `WhiteNoise`, `PinkNoise`, `RadialPerturbation`, `noise_process_dict`),
  copied so that the port imports nothing of the JAX package;
* `ou_step`, the in-graph Ornstein-Uhlenbeck step of the env's observation
  noise, in torch, drawing from an explicit `torch.Generator`.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class EmptyNoise:
    def __init__(self, shape, dt=0.02, **kw):
        self.shape = shape

    def step(self):
        return np.zeros(self.shape)

    def reset(self):
        pass


class OUProcess:
    """Ornstein-Uhlenbeck: dx = theta (mu - x) dt + sigma sqrt(dt) N(0,1)."""

    def __init__(self, shape, dt=0.02, theta=1.0, mu=0.0, sigma=1.0, **kw):
        self.shape, self.dt, self.theta, self.mu, self.sigma = shape, dt, theta, mu, sigma
        self.x = np.zeros(shape)

    def step(self):
        self.x = self.x + self.theta * (self.mu - self.x) * self.dt + \
            self.sigma * np.sqrt(self.dt) * np.random.standard_normal(self.shape)
        return self.x.copy()

    def reset(self):
        self.x[:] = 0

    def reset_part(self, mask):
        self.x = np.where(mask, 0.0, self.x)


class WhiteNoise:
    def __init__(self, shape, dt=0.02, sigma=1.0, **kw):
        self.shape, self.sigma = shape, sigma

    def step(self):
        return self.sigma * np.random.standard_normal(self.shape)

    def reset(self):
        pass


class PinkNoise:
    """1/f noise via the Voss-McCartney multi-rate sum."""

    def __init__(self, shape, dt=0.02, sigma=1.0, n_rows=16, **kw):
        self.shape, self.sigma, self.n = shape, sigma, n_rows
        self.rows = np.random.standard_normal((n_rows,) + tuple(shape))
        self.counter = 0

    def step(self):
        self.counter += 1
        c = self.counter
        for i in range(self.n):
            if c % (1 << i) == 0:
                self.rows[i] = np.random.standard_normal(self.shape)
        return self.sigma * self.rows.sum(0) / np.sqrt(self.n)

    def reset(self):
        self.counter = 0
        self.rows = np.random.standard_normal((self.n,) + tuple(self.shape))


class RadialPerturbation:
    """Lognormal-magnitude x von-Mises-Fisher-direction perturbation of a
    vector (`noise_tool.py:103`); used for joint-velocity attacks in deploy."""

    def __init__(self, kappa=50.0, sigma_log=0.1, **kw):
        self.kappa = kappa
        self.sigma_log = sigma_log

    def apply(self, v):
        v = np.asarray(v, dtype=np.float64)
        norm = np.linalg.norm(v)
        if norm < 1e-8:
            return v
        mu = v / norm
        # a vMF direction around mu (Wood's method, d = len(v))
        d = v.shape[0]
        b = (-2 * self.kappa + np.sqrt(4 * self.kappa**2 + (d - 1) ** 2)) / (d - 1)
        x0 = (1 - b) / (1 + b)
        c = self.kappa * x0 + (d - 1) * np.log(1 - x0**2)
        while True:
            z = np.random.beta((d - 1) / 2, (d - 1) / 2)
            w = (1 - (1 + b) * z) / (1 - (1 - b) * z)
            u = np.random.uniform()
            if self.kappa * w + (d - 1) * np.log(1 - x0 * w) - c >= np.log(u):
                break
        vtan = np.random.standard_normal(d)
        vtan -= vtan.dot(mu) * mu
        vtan /= max(np.linalg.norm(vtan), 1e-9)
        direction = w * mu + np.sqrt(max(1 - w**2, 0.0)) * vtan
        mag = norm * np.exp(self.sigma_log * np.random.standard_normal())
        return mag * direction


noise_process_dict = {
    "empty": EmptyNoise,
    "OU": OUProcess,
    "white": WhiteNoise,
    "pink": PinkNoise,
}


def ou_step(x, generator: torch.Generator, dt, theta=1.0, mu=0.0, sigma=1.0):
    """One OU step of the state `x` with a standard normal draw from
    `generator` (`noise_tool.py:183`). Returns (new state, sample), the two equal."""
    noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    x = x + theta * (mu - x) * dt + sigma * math.sqrt(dt) * noise
    return x, x
