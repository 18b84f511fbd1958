"""The work a cell asks of the device, as pure functions of the sizes in its
configuration file. Nothing here reads the program: the yardstick counts the
same work whatever implements it.

Peaks are NVIDIA's data sheet for the H100 SXM (dense rates, 700 W): float32
outside the tensor cores and HBM3 bandwidth. The configurations state float32
with TF32 off, so the float32 peak is the one a step's share is taken of.
"""
from __future__ import annotations

import importlib

H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
FLOAT32_BYTES = 4


def mlp_macs(in_dim: int, hidden: list, out_dim: int) -> int:
    """Multiply-accumulates of one forward pass of a dense MLP, per sample."""
    dims = [in_dim, *hidden, out_dim]
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def networks(config: dict):
    """The per-sample counts of the configuration's networks:
    `portbench/counts/<learner reference>.py`."""
    return importlib.import_module(f"portbench.counts.{config['references']['learner']}")


def apgd_lanes_bytes(R: int, N: int, dtype_bytes: int = FLOAT32_BYTES) -> int:
    """Bytes kernel 1 must move once: A [3R,3R,N], b and x0 [3R,N], mu [N],
    active [R,N] read, the impulses [3R,N] written."""
    n = 3 * R
    return (n * n * N + 2 * n * N + N + R * N + n * N) * dtype_bytes


def apgd_lanes_flops(R: int, N: int, iters: int) -> int:
    """Kernel 1's matvec work: `iters` products of A [3R,3R] with a vector per
    env, 2 flops per multiply-accumulate. The projection and the Lipschitz
    bound are lower order and left out."""
    n = 3 * R
    return iters * 2 * n * n * N


def apgd_lanes_bound_s(R: int, N: int, iters: int, dtype_bytes: int = FLOAT32_BYTES) -> float:
    """The least time kernel 1 can take on the card: the larger of its bytes
    over the bandwidth and its flops over the float32 peak (bytes bound it)."""
    return max(apgd_lanes_bytes(R, N, dtype_bytes) / H100_HBM_BYTES_PER_S,
               apgd_lanes_flops(R, N, iters) / H100_FP32_FLOPS)


def solve_flops_per_control_step(config: dict) -> int:
    """Kernel 1 launches once per physics substep."""
    return config["decimation"] * apgd_lanes_flops(config["contact_rows"], config["num_envs"],
                                                   config["solver_iters"])


def serve_step_flops(config: dict) -> int:
    """One control step of serving: the actor's forward over every env and the
    contact solves. The engine's elementwise arithmetic has no count from
    shapes and is left out."""
    return 2 * networks(config).serve_macs(config) * config["num_envs"] + solve_flops_per_control_step(config)


def train_iteration_flops(config: dict) -> int:
    """One training iteration: the rollout's networks per env-step and its
    contact solves, then per epoch a forward and backward pass (3 x forward)
    of what the update differentiates over every sample, and a forward pass
    of what it does not."""
    net = networks(config)
    samples = config["num_envs"] * config["num_steps_per_env"]
    update = 3 * 2 * net.update_macs(config) + 2 * net.update_nograd_macs(config)
    return samples * 2 * net.rollout_macs(config) \
        + config["num_steps_per_env"] * solve_flops_per_control_step(config) \
        + config["num_learning_epochs"] * samples * update
