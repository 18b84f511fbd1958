#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's serving path, `pbhc_tpu_torch.eval.batch_eval.episode_ratio`
on the committed KungfuBot-v1 side-kick checkpoint at 4096 envs over the
whole clip, and holds every CUDA kernel of that path against its plain
PyTorch version. Phases, each announced when it starts and when it ends:

  1. build   - compile the kernels from `pbhc_tpu_torch/csrc/` with nvcc (sm_90a)
  2. kernel  - kernel vs plain version at the path's shape, with timings
  3. substep - one lanes control step at 4096 envs, kernel vs plain solve
  4. serving - the episode_ratio rollout; kernel launches counted from 0
  5. report  - the `kernels` JSON line, the card line, the final result line

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It needs one CUDA card and exits non-zero, printing no result, if any phase
fails or no card is present. It imports no JAX and nothing of `pbhc_tpu`.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = "artifacts/kb1_side_kick/ckpt/model_10500.pkl"
NUM_ENVS = 4096
ROWS = 12           # contact_cap 8 ground rows + pair_cap 4 self-collision rows
ITERS = 16          # solver_iters of the side-kick run config
SETTLE_STEPS = 10   # policy steps before the kernel-vs-plain control step

# Tolerances (each stated with its reason):
# - kernel vs plain solve: the two sum the 36-term matvecs in different
#   orders (and the kernel fuses multiply-adds); 16 momentum iterations keep
#   the f32 difference far below 1e-4, the repo's own kernel-parity bound
#   (tests/test_pallas_contact.py::test_lanes_kernel_matches_xla_apgd).
KERNEL_ATOL = 1e-4
# - one control step with kernel vs plain solve: the solve's f32 noise passes
#   through 4 substeps; a relative 1e-3 of each field's scale is 10x tighter
#   than the repo's own lanes-parity bound (1e-2 over 25 control steps).
STEP_RTOL = 1e-3
# - serving ratio: the JAX package's own figure for this checkpoint at 4096
#   envs on the CPU (python -m pbhc_tpu.eval.batch_eval ... num_envs=4096,
#   see PERF.md). The port draws its domain randomisation from other random
#   streams, so it is held to a band of 0.02 around that figure.
JAX_RATIO = 0.9982211
RATIO_BAND = 0.02

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores, H100 SXM data sheet


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    log(f"[phase {name}] start")
    yield
    log(f"[phase {name}] ok in {time.perf_counter() - t0:.1f} s")


def card_line(torch):
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(0)}, power limit not read (no nvidia-smi)"


def cuda_ms(torch, fn, reps):
    """Mean device time of `fn()` over `reps` runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def apgd_bound_ms(R, N, iters):
    """Least time for the solve: each input read once and the output written
    once over the memory rate, or its f32 operations over the f32 rate."""
    n = 3 * R
    nbytes = 4 * N * (n * n + n + 1 + R + n + n)        # A, b, mu, active, x0 -> out
    # Lipschitz bound (abs, mul, add per entry) + per iteration the matvec
    # (mul+add per entry) and ~12 ops per row for momentum and projection
    ops = N * (3 * n * n + iters * (2 * n * n + 12 * n))
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    from pbhc_tpu_torch.eval import batch_eval
    from pbhc_tpu_torch.sim import contact_kernel
    from pbhc_tpu_torch.utils import nvcc

    batch_eval.set_precision()
    dev = torch.device("cuda:0")
    card = card_line(torch)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernel = contact_kernel.apgd_lanes
    ok = True

    with phase("build"):
        t0 = time.perf_counter()
        logs = nvcc.build([contact_kernel.LIBRARY])
        log(f"build seconds: {time.perf_counter() - t0:.2f}")
        for name, out in logs.items():
            for line in out.splitlines():
                if "registers" in line or "spill" in line or "error" in line.lower():
                    log(f"  {name}: {line.strip()}")

    with phase("kernel"):
        g = torch.Generator(device=dev).manual_seed(0)
        n, N = 3 * ROWS, NUM_ENVS
        J = torch.randn((n, 40, N), generator=g, device=dev) * 0.3
        A = (torch.einsum("ivn,jvn->ijn", J, J) + 1e-2 * torch.eye(n, device=dev)[:, :, None]).contiguous()
        b = torch.randn((n, N), generator=g, device=dev)
        mu = 0.2 + torch.rand((N,), generator=g, device=dev)
        active = (torch.rand((ROWS, N), generator=g, device=dev) > 0.3).float()
        x0 = torch.rand((n, N), generator=g, device=dev) * 0.5
        out = kernel(A, b, mu, active, x0, ITERS)
        ref = contact_kernel.apgd_lanes_plain(A, b, mu, active, x0, ITERS)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        finite = bool(torch.isfinite(out).all())
        kernel_ms = cuda_ms(torch, lambda: kernel(A, b, mu, active, x0, ITERS), 50)
        plain_ms = cuda_ms(torch, lambda: contact_kernel.apgd_lanes_plain(A, b, mu, active, x0, ITERS), 10)
        bound_ms, bound_by = apgd_bound_ms(ROWS, N, ITERS)
        log(f"apgd_lanes R={ROWS} N={N} iters={ITERS}: max_abs_err {err:.3e} (tol {KERNEL_ATOL:g}), "
            f"|ref| max {float(ref.abs().max()):.3f}, kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}) on {card}")
        if not (finite and err <= KERNEL_ATOL):
            log("FAIL: kernel disagrees with its plain version")
            ok = False

    with phase("substep"):
        env, actor, _ = batch_eval.load(CKPT, NUM_ENVS, device=dev)
        state, obs = batch_eval.start_episodes(env)
        with torch.no_grad():
            # settle onto the soles first: at clip time 0 no contact row is active
            for _ in range(SETTLE_STEPS):
                state, obs, _, _, _ = env.step(state, actor(obs["actor_obs"])[0])
            mean, _ = actor(obs["actor_obs"])
        target = mean * env.action_scales + state.default_dof_pos
        kp, kd = state.kp_scale * env.p_gains, state.kd_scale * env.d_gains

        def pd(st):
            return torch.clamp(kp * (target - st.dof_pos) - kd * st.dof_vel, -env.torque_limits, env.torque_limits)

        lanes = env.lanes_engine
        outs = {}
        for name, solve in (("kernel", contact_kernel.apgd_lanes), ("plain", contact_kernel.apgd_lanes_plain)):
            lanes.contact_solve = solve
            outs[name], _ = lanes.control_step_batched(env.sim_params, state.sim, pd, env.decimation,
                                                       paramsT=env.paramsT)
        lanes.contact_solve = contact_kernel.apgd_lanes
        torch.cuda.synchronize()
        worst = 0.0
        for f in ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "dof_pos", "dof_vel",
                  "body_pos", "contact_forces"):
            a, p = getattr(outs["kernel"], f), getattr(outs["plain"], f)
            rel = float((a - p).abs().max()) / max(1.0, float(p.abs().max()))
            worst = max(worst, rel)
            if not (bool(torch.isfinite(a).all()) and rel <= STEP_RTOL):
                log(f"FAIL: control step field {f}: relative diff {rel:.3e} (tol {STEP_RTOL:g})")
                ok = False
        in_contact = int((outs["plain"].contact_forces.abs().sum((1, 2)) > 0).sum())
        log(f"one control step at {NUM_ENVS} envs ({in_contact} with contact impulses), kernel vs "
            f"plain solve: max relative diff {worst:.3e} (tol {STEP_RTOL:g})")
        if in_contact < NUM_ENVS // 2:
            log("FAIL: too few envs in contact for the comparison to test the solve")
            ok = False
        del env, actor, state, obs, outs

    with phase("serving"):
        kernel.launches = 0
        res = batch_eval.episode_ratio(CKPT, NUM_ENVS, device=dev)
        launches = kernel.launches
        log("episode_ratio: " + json.dumps(res))
        want = 4 * res["episode_steps"]
        if launches != want:
            log(f"FAIL: apgd_lanes launched {launches} times, want 4 x {res['episode_steps']} = {want}")
            ok = False
        if res["nonfinite_env_steps"] != 0:
            log(f"FAIL: {res['nonfinite_env_steps']} env-steps ended non-finite")
            ok = False
        if not abs(res["ratio"] - JAX_RATIO) <= RATIO_BAND:
            log(f"FAIL: ratio {res['ratio']:.6f} outside {JAX_RATIO} +- {RATIO_BAND}")
            ok = False
        log(f"control_steps_per_sec {res['control_steps_per_sec']:.3f} at {NUM_ENVS} envs on {card}")

    if not ok:
        log("chip_smoke: FAILED")
        return 1
    with phase("report"):
        kernels = [{
            "name": "apgd_lanes", "route": "cuda", "source": "pbhc_tpu_torch/csrc/apgd_lanes.cu",
            "replaces": "pbhc_tpu/sim/pallas_contact.py:112", "launches": launches,
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
