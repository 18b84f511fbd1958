"""Procedural heightfield terrain (counterpart of `pbhc_tpu/envs/terrain.py:16-129`).

A grid of sub-terrains (flat, rough, smooth slope, rough slope, discrete
obstacles) in one heightfield array; rows form a difficulty curriculum. The
generator is seeded numpy (`np.random.default_rng(0)`), drawn in the JAX
module's order, so the field and the tile origins are the same bit for bit
(`tests/test_torch_terrain.py`). The engines take the field as a tensor and
look heights up bilinearly under each contact sphere
(`Engine.ground_height`).

The MuJoCo writers of the JAX module (`export_mujoco`, `swap_sphere_soles`,
`fill_mujoco_hfield`) are not here: they serve sim2sim, ROADMAP queue 1
item 13.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TerrainConfig:
    horizontal_scale: float = 0.1       # m per cell
    vertical_scale: float = 0.005       # m per height unit
    num_rows: int = 10                  # difficulty levels
    num_cols: int = 20
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    border_size: float = 25.0
    # flat, rough, smooth slope, rough slope, discrete obstacles
    terrain_proportions: tuple = (0.1, 0.1, 0.35, 0.25, 0.2)

    @classmethod
    def from_group(cls, tcfg) -> "TerrainConfig":
        """From a run config's `terrain:` group, with the defaults the env
        applies to missing keys (`tracking_env.py:152-161`)."""
        return cls(
            horizontal_scale=float(tcfg.get("horizontal_scale", 0.1)),
            num_rows=int(tcfg.get("num_rows", 10)),
            num_cols=int(tcfg.get("num_cols", 20)),
            terrain_length=float(tcfg.get("terrain_length", 8.0)),
            terrain_width=float(tcfg.get("terrain_width", 8.0)),
            border_size=float(tcfg.get("border_size", 25.0)),
            terrain_proportions=tuple(tcfg.get("terrain_proportions", (0.1, 0.1, 0.35, 0.25, 0.2))))


class Terrain:
    """Heightfield grid (`terrain.py:29`). `height_field` [H,W] is in metres;
    `env_origins` [rows,cols,3] are the tile centres."""

    def __init__(self, cfg: TerrainConfig = TerrainConfig(), rng=None):
        self.cfg = cfg
        rng = rng or np.random.default_rng(0)
        self.length_px = int(cfg.terrain_length / cfg.horizontal_scale)
        self.width_px = int(cfg.terrain_width / cfg.horizontal_scale)
        self.border_px = int(cfg.border_size / cfg.horizontal_scale)
        H = cfg.num_rows * self.length_px + 2 * self.border_px
        W = cfg.num_cols * self.width_px + 2 * self.border_px
        self.height_field = np.zeros((H, W), dtype=np.float32)
        self.env_origins = np.zeros((cfg.num_rows, cfg.num_cols, 3), dtype=np.float32)
        for i in range(cfg.num_rows):
            difficulty = (i + 1) / cfg.num_rows
            for j in range(cfg.num_cols):
                choice = rng.uniform()
                tile = self._make_tile(choice, difficulty, rng)
                r0 = self.border_px + i * self.length_px
                c0 = self.border_px + j * self.width_px
                self.height_field[r0:r0 + self.length_px, c0:c0 + self.width_px] = tile
                cx = (r0 + self.length_px // 2) * cfg.horizontal_scale
                cy = (c0 + self.width_px // 2) * cfg.horizontal_scale
                cz = tile[self.length_px // 2, self.width_px // 2]
                self.env_origins[i, j] = (cx, cy, cz)

    def _make_tile(self, choice, difficulty, rng):
        """One sub-terrain (`terrain.py:56`); the draws in the JAX order."""
        L, W = self.length_px, self.width_px
        p = np.cumsum(self.cfg.terrain_proportions)
        if choice < p[0]:
            return np.zeros((L, W), dtype=np.float32)
        if choice < p[1]:  # rough flat
            amp = 0.025 + 0.05 * difficulty
            return rng.uniform(-amp, amp, (L, W)).astype(np.float32)
        if choice < p[2]:  # smooth slope
            slope = 0.25 * difficulty * (1 if rng.uniform() < 0.5 else -1)
            x = np.linspace(0, self.cfg.terrain_length * slope, L, dtype=np.float32)
            return np.broadcast_to(x[:, None], (L, W)).copy()
        if choice < p[3]:  # rough slope
            slope = 0.25 * difficulty * (1 if rng.uniform() < 0.5 else -1)
            x = np.linspace(0, self.cfg.terrain_length * slope, L, dtype=np.float32)
            amp = 0.02 + 0.04 * difficulty
            return (x[:, None] + rng.uniform(-amp, amp, (L, W))).astype(np.float32)
        # discrete obstacles
        tile = np.zeros((L, W), dtype=np.float32)
        h = 0.05 + 0.15 * difficulty
        for _ in range(20):
            oh = rng.uniform(-h, h)
            ol = rng.integers(4, 16)
            ow = rng.integers(4, 16)
            r = rng.integers(0, L - ol)
            c = rng.integers(0, W - ow)
            tile[r:r + ol, c:c + ow] = oh
        return tile

    @classmethod
    def from_run_config(cls, tcfg):
        """The (deterministic, seed-0) terrain of a run config's `terrain:`
        group (`terrain.py:85`)."""
        if tcfg["mesh_type"] != "heightfield":
            raise ValueError("run was not terrain-trained")
        return cls(TerrainConfig(
            horizontal_scale=float(tcfg["horizontal_scale"]),
            vertical_scale=float(tcfg.get("vertical_scale", 0.005)),
            num_rows=int(tcfg["num_rows"]), num_cols=int(tcfg["num_cols"]),
            terrain_length=float(tcfg["terrain_length"]),
            terrain_width=float(tcfg["terrain_width"]),
            border_size=float(tcfg["border_size"]),
            terrain_proportions=tuple(tcfg["terrain_proportions"])))

    def height_at(self, xy):
        """Bilinear terrain height [K] under world xy [K,2], in float64 (numpy
        twin of `Engine.ground_height`: world x -> row i = x / hscale, corner
        at 0,0; `terrain.py:99`)."""
        xy = np.asarray(xy, np.float64)
        hf = self.height_field
        hs = self.cfg.horizontal_scale
        i = np.clip(xy[..., 0] / hs, 0.0, hf.shape[0] - 1.001)
        j = np.clip(xy[..., 1] / hs, 0.0, hf.shape[1] - 1.001)
        i0, j0 = np.floor(i).astype(int), np.floor(j).astype(int)
        fi, fj = i - i0, j - j0
        return (hf[i0, j0] * (1 - fi) * (1 - fj)
                + hf[i0, j0 + 1] * (1 - fi) * fj
                + hf[i0 + 1, j0] * fi * (1 - fj)
                + hf[i0 + 1, j0 + 1] * fi * fj)

    def sample_origins(self, num_envs, rng=None, max_row=None):
        """Env origins spread over the terrain grid, rows capped at `max_row`
        (`terrain.py:115`)."""
        rng = rng or np.random.default_rng(1)
        rows = rng.integers(0, max_row or self.cfg.num_rows, num_envs)
        cols = rng.integers(0, self.cfg.num_cols, num_envs)
        return self.env_origins[rows, cols]
