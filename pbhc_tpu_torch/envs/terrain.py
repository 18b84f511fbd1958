"""Procedural heightfield terrain (counterpart of `pbhc_tpu/envs/terrain.py:16-129`).

A grid of sub-terrains (flat, rough, smooth slope, rough slope, discrete
obstacles) in one heightfield array; rows form a difficulty curriculum. The
generator is seeded numpy (`np.random.default_rng(0)`), drawn in the JAX
module's order, so the field and the tile origins are the same bit for bit
(`tests/test_torch_terrain.py`). The engines take the field as a tensor and
look heights up bilinearly under each contact sphere
(`Engine.ground_height`).

The MuJoCo writers (`Terrain.export_mujoco`, `swap_sphere_soles`,
`fill_mujoco_hfield`, `terrain.py:122-249`) write the same scene XML and
hfield data as the JAX module, for the sim2sim runtimes; they import no
MuJoCo themselves (`fill_mujoco_hfield` fills a model the caller compiled).
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

    # ------------------------------------------------------------- mujoco
    def export_mujoco(self, robot_xml_path, out_xml_path, sphere_feet=True):
        """Write a MuJoCo scene XML with this terrain as an hfield asset
        replacing the robot XML's floor plane, plus a sidecar .npz with the
        elevation data (hfield data can't be inlined in XML; the loader calls
        `fill_mujoco_hfield`). Geometry matches the engine's lookup
        (engine.ground_height: world x -> row, world y -> col, corner at 0,0).

        sphere_feet: on hfield scenes the *_ankle_roll collision MESH is
        swapped for the engine's 4-corner sphere sole (model.g1
        G1_FOOT_SOLE_SPHERES). mesh<->hfield is MuJoCo's weakest contact
        pair (per-prism convex tests, few contacts, noisy normals at cell
        edges) — a policy that completes on the plane scene falls within
        ~1.5 s on a FLAT hfield tile with mesh feet; sphere<->hfield is the
        robust pair and matches the geometry the policy trained on.

        reference parity: PhysX heightfield terrain for sim (isaacgym.py:
        89-150) gets no MuJoCo twin in the reference; this closes that gap so
        rough-terrain policies can be replayed sim2sim.
        """
        import re
        from pathlib import Path

        hf = self.height_field
        H, W = hf.shape
        hs = self.cfg.horizontal_scale
        zmin, zmax = float(hf.min()), float(hf.max())
        elev = max(zmax - zmin, 1e-3)
        # Exact grid registration with the engine: MuJoCo places ncol samples
        # EVENLY over [-rx, rx] (spacing 2rx/(ncol-1)), while the engine puts
        # sample i at world x = i*hs. rx = (H-1)*hs/2 with the geom centered
        # at ((H-1)*hs/2, ...) makes MuJoCo sample k sit exactly at x = k*hs
        # (using H*hs/2 stretches the map by H/(H-1): ~2 cm height error on
        # mid-map slopes at H=200).
        rx, ry = (H - 1) * hs / 2.0, (W - 1) * hs / 2.0
        # mujoco hfield: data[row, col]; col spans x in [-rx, rx], row spans y
        asset = (f'<hfield name="terrain" nrow="{W}" ncol="{H}" '
                 f'size="{rx} {ry} {elev} 1.0"/>')
        geom = (f'<geom name="terrain" type="hfield" hfield="terrain" '
                f'pos="{rx} {ry} {zmin}" contype="15" conaffinity="15"/>')

        robot_xml_path = Path(robot_xml_path)
        xml = robot_xml_path.read_text()
        xml, n = re.subn(r'<geom[^>]*name="floor"[^>]*/>', geom, xml)
        if n != 1:
            raise ValueError(f"{robot_xml_path}: want one floor plane geom to replace, found {n}")
        # retarget explicit <contact><pair geom2="floor"> entries (rev_2 XML)
        # at the replacement geom, or the compile fails on the dangling name
        xml = xml.replace('geom2="floor"', 'geom2="terrain"')
        if sphere_feet:
            xml = swap_sphere_soles(xml)
        xml = xml.replace("<asset>", f"<asset>\n    {asset}", 1)
        # the scene may be written outside the robot dir: absolutize meshdir
        xml = re.sub(r'meshdir="([^"]*)"',
                     lambda m: f'meshdir="{(robot_xml_path.parent / m.group(1)).resolve()}"',
                     xml)
        out_xml_path = Path(out_xml_path)
        out_xml_path.write_text(xml)
        np.savez(str(out_xml_path) + ".terrain.npz",
                 data=((hf.T - zmin) / elev).astype(np.float32))
        return out_xml_path


def swap_sphere_soles(xml, style="box"):
    """Swap colliding *_ankle_roll MESH geoms for an engine-matched sole,
    keeping the mesh as visual-only.

    style="sphere": the engine's 4-corner sphere sole verbatim
    (model.g1 G1_FOOT_SOLE_SPHERES). style="box" (default): one box whose
    BOTTOM FACE spans the same 4 sphere-bottom corners (same sole plane
    z=-0.035, same support rectangle). Box is the default because MuJoCo
    3.10's hfield convex test silently MISSES r=5-17.5 mm spheres (measured:
    sole spheres sink 10 cm through a FLAT hfield tile with ncon=3/8, while
    box soles reproduce the plane-scene trajectory exactly — the tiny-geom-
    vs-prism MPR failure mode); sphere<->plane is fine, so plane scenes can
    keep spheres.

    Attribute-order tolerant; robot variants whose ankle collision is already
    primitive (29dof_rev_1_0: spheres; rev_2: capsules) have no colliding
    ankle meshes; primitive contact pairs are robust already, so the swap is
    a warned no-op there."""
    import re

    from pbhc_tpu_torch.model.g1 import G1_FOOT_SOLE_SPHERES

    xs = [s[0] for s in G1_FOOT_SOLE_SPHERES]
    ys = [s[1] for s in G1_FOOT_SOLE_SPHERES]
    z0 = min(s[2] - s[3] for s in G1_FOOT_SOLE_SPHERES)   # sole plane
    r0 = max(s[3] for s in G1_FOOT_SOLE_SPHERES)
    hx = (max(xs) - min(xs)) / 2 + r0
    hy = (max(ys) - min(ys)) / 2 + r0
    cx, cy = (max(xs) + min(xs)) / 2, (max(ys) + min(ys)) / 2
    hz = 0.0025
    if style == "box":
        sole = (f'<geom type="box" size="{hx} {hy} {hz}" '
                f'pos="{cx} {cy} {z0 + hz}" contype="15" conaffinity="15"/>')
    else:
        sole = "\n                  ".join(
            f'<geom type="sphere" size="{r}" pos="{x} {y} {z}" '
            f'contype="15" conaffinity="15"/>'
            for x, y, z, r in G1_FOOT_SOLE_SPHERES)

    def _sole(m):
        tag, mesh = m.group(0), m.group(1)
        # visual-only geoms (contype 0 / class visual) keep rendering
        if 'contype="0"' in tag or 'class="visual"' in tag:
            return tag
        return (f'<geom type="mesh" contype="0" conaffinity="0" '
                f'rgba="0.2 0.2 0.2 1" mesh="{mesh}"/>\n'
                f'                  {sole}')

    pat = r'<geom\b[^>]*\bmesh="((?:left|right)_ankle_roll_link)"[^>]*/>'
    n_coll = sum(1 for m in re.finditer(pat, xml)
                 if 'contype="0"' not in m.group(0)
                 and 'class="visual"' not in m.group(0))
    if n_coll == 0:
        import warnings
        warnings.warn(
            "swap_sphere_soles: no colliding ankle mesh geoms in this robot "
            "XML; keeping its primitive foot collision as-is")
        return xml
    if n_coll != 2:
        raise ValueError(f"want 2 ankle_roll collision meshes, found {n_coll}")
    return re.sub(pat, _sole, xml)


def fill_mujoco_hfield(model, xml_path):
    """Load the sidecar elevation of `export_mujoco` into a compiled
    `MjModel`'s hfield buffer; returns the model."""
    data = np.load(str(xml_path) + ".terrain.npz")["data"]
    model.hfield_data[:] = data.reshape(-1)
    return model
