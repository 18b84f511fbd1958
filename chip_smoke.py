#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two paths, each through the entry points a user calls, and
holds every CUDA kernel they launch against its plain PyTorch version:
- serving: `pbhc_tpu_torch.eval.batch_eval.episode_ratio` on the committed
  KungfuBot-v1 side-kick checkpoint at 4096 envs over the whole clip
  (kernel 1, `apgd_lanes`);
- training: `pbhc_tpu_torch.train.main`, the training CLI, on `bench.py`'s
  configuration (G1 23-DoF, 4096 envs, full domain randomisation, random
  weights from seed 0; run directories under `build/chip_smoke/`), once with
  `solver: lanes` (kernel 1) and once with `solver: pallas` (kernel 2,
  `apgd_envfirst`).
Phases, each announced when it starts and when it ends:

  build            - compile both kernels from `pbhc_tpu_torch/csrc/` (nvcc, sm_90a, in parallel)
  kernel           - each kernel vs its plain version at the paths' shapes, with timings
  substep          - one lanes control step at 4096 envs, kernel 1 vs plain solve
  substep-envfirst - one env-first control step at 4096 envs, kernel 2 vs plain solve
  serving          - the episode_ratio rollout; kernel launches counted from 0
  train-lanes      - the training CLI for 3 iterations, solver lanes; launches counted from 0
  train-pallas     - the training CLI for 2 iterations, solver pallas; launches counted from 0
  update           - one minibatch update on the card and on the CPU, same state and batch
  checkpoint       - read back the `.pkl` the train-pallas run wrote
  report           - the `kernels` JSON line, the card line, the final result line

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It needs one CUDA card and exits non-zero, printing no result, if any phase
fails or no card is present. It imports no JAX and nothing of `pbhc_tpu`.
"""
from __future__ import annotations

import contextlib
import copy
import glob
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
ALL_ROWS = 38       # every row of the G1 23-DoF model (21 spheres + 17 pairs), contact_cap 0
ITERS = 16          # solver_iters of the side-kick and training configs
SETTLE_STEPS = 10   # steps before a kernel-vs-plain control step
TRAIN_SELECTIONS = ["exp=motion_tracking", "robot=g1_23dof", "obs=motion_tracking",
                    "rewards=motion_tracking", "domain_rand=main", "simulator=tpu"]
TRAIN_OVERRIDES = [f"num_envs={NUM_ENVS}", "robot.motion.motion_file=assets/motions/Horse-stance_punch.pkl"]
TRAIN_ITERS = {"lanes": 3, "pallas": 2}
UPDATE_SAMPLES = 24576   # one minibatch of the training config: 24 steps x 4096 envs / 4

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
# - one minibatch update on the card vs on the CPU, TF32 off, from the train
#   state after the train-lanes phase (a mid-training Adam state: a fresh
#   Adam's first step would turn the f32 rounding of near-zero gradients into
#   differences of up to lr) on a batch near its policy (see update_batch):
#   the two devices sum the products in different orders; 1e-5 is the bound
#   tests/test_torch_ppo.py holds the port to against optax.
UPDATE_ATOL = 1e-5

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


def envfirst_bound_ms(R, N, iters):
    """Kernel 2: A, b, mu and active read once, the impulses written once;
    the Lipschitz bound and per iteration the matvec and ~12 ops per row."""
    n = 3 * R
    nbytes = 4 * N * (n * n + 2 * n + 1 + R)
    ops = N * (3 * n * n + iters * (2 * n * n + 12 * n))
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def envfirst_problem(torch, R, N, dev, seed):
    """Random SPD Delassus matrices with ~30% inactive rows, env-first."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = 3 * R
    J = torch.randn((N, n, 40), generator=g, device=dev) * 0.3
    A = (J @ J.transpose(1, 2) + 1e-2 * torch.eye(n, device=dev)).contiguous()
    b = torch.randn((N, n), generator=g, device=dev)
    mu = 0.2 + torch.rand((N,), generator=g, device=dev)
    active = (torch.rand((N, R), generator=g, device=dev) > 0.3).float()
    return A, b, mu, active


def compare_steps(torch, outs, tol):
    """Max relative difference (to each field's scale) of two control steps;
    logs and returns (worst, ok)."""
    worst, ok = 0.0, True
    for f in ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "dof_pos", "dof_vel",
              "body_pos", "contact_forces"):
        a, p = getattr(outs["kernel"], f), getattr(outs["plain"], f)
        rel = float((a - p).abs().max()) / max(1.0, float(p.abs().max()))
        worst = max(worst, rel)
        if not (bool(torch.isfinite(a).all()) and rel <= tol):
            log(f"FAIL: control step field {f}: relative diff {rel:.3e} (tol {tol:g})")
            ok = False
    return worst, ok


def cpu_copy(algo, ts, torch):
    """The networks and optimizer states of `ts` on the CPU."""
    actor, critic = copy.deepcopy(ts.actor).cpu(), copy.deepcopy(ts.critic).cpu()
    out = algo.new_train_state(actor, critic)
    out.lr = ts.lr.cpu().clone()
    for src, dst in ((ts.actor_opt, out.actor_opt), (ts.critic_opt, out.critic_opt)):
        dst.count = src.count
        for a, b in zip(dst.mu + dst.nu, src.mu + src.nu):
            a.copy_(b.cpu())
    return out


def update_batch(torch, algo, ts, n):
    """A seeded minibatch of `n` samples drawn near the policy of `ts`, as the
    first minibatches of an update phase see them: the stored values are the
    critic's, the stored mean is the actor's moved by 0.01 (so the KL is
    ~2e-3, inside the band where the adaptive lr rises) and the std is the
    actor's. Off-policy data, far from these, puts some samples' clipped
    surrogate and clipped value loss within f32 rounding of their switch
    points, where the card and the CPU may take different branches."""
    from pbhc_tpu_torch.agents.networks import gaussian_log_prob

    g = torch.Generator().manual_seed(1)
    rn = lambda *shape: torch.randn(shape, generator=g)
    aobs, cobs = rn(n, algo.actor_dim), rn(n, algo.critic_dim)
    with torch.no_grad():
        mean, std = ts.actor(aobs)
        values = ts.critic(cobs)
    mean = mean + 0.01 * rn(n, algo.num_act)
    actions = mean + std * rn(n, algo.num_act)
    return dict(actor_obs=aobs, critic_obs=cobs, actions=actions,
                logp=gaussian_log_prob(mean, std, actions), mean=mean, std=std, values=values,
                returns=values + 0.3 * rn(n, algo.num_rew), advantages=rn(n))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    from pbhc_tpu_torch import train
    from pbhc_tpu_torch.agents.convert import flax_params, from_flax
    from pbhc_tpu_torch.agents.networks import actor_from_config, critic_from_config
    from pbhc_tpu_torch.config.loader import compose
    from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv
    from pbhc_tpu_torch.eval import batch_eval
    from pbhc_tpu_torch.sim import contact_kernel
    from pbhc_tpu_torch.utils import nvcc
    from pbhc_tpu_torch.utils.checkpoint import load_checkpoint_payload

    batch_eval.set_precision()
    dev = torch.device("cuda:0")
    card = card_line(torch)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    k1, k2 = contact_kernel.apgd_lanes, contact_kernel.apgd_envfirst
    ok = True
    stats = {"apgd_lanes": {}, "apgd_envfirst": {}}
    launches = {"apgd_lanes": {}, "apgd_envfirst": {}}

    def count(path, fn):
        """Run `fn` with both kernels' launch counts set to 0, then record them."""
        k1.launches = k2.launches = 0
        out = fn()
        torch.cuda.synchronize()
        launches["apgd_lanes"][path], launches["apgd_envfirst"][path] = k1.launches, k2.launches
        log(f"{path}: apgd_lanes launched {k1.launches}, apgd_envfirst launched {k2.launches}")
        return out

    def expect_launches(path, want):
        nonlocal ok
        for name, n in want.items():
            if launches[name][path] != n:
                log(f"FAIL: {path}: {name} launched {launches[name][path]} times, want {n}")
                ok = False

    with phase("build"):
        t0 = time.perf_counter()
        logs = nvcc.build(contact_kernel.LIBRARIES)
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
        out = k1(A, b, mu, active, x0, ITERS)
        ref = contact_kernel.apgd_lanes_plain(A, b, mu, active, x0, ITERS)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        finite = bool(torch.isfinite(out).all())
        bound_ms, bound_by = apgd_bound_ms(ROWS, N, ITERS)
        stats["apgd_lanes"] = dict(
            max_abs_err=err, ms=cuda_ms(torch, lambda: k1(A, b, mu, active, x0, ITERS), 50),
            plain_ms=cuda_ms(torch, lambda: contact_kernel.apgd_lanes_plain(A, b, mu, active, x0, ITERS), 10),
            bound_ms=bound_ms, bound_by=bound_by)
        st = stats["apgd_lanes"]
        log(f"apgd_lanes R={ROWS} N={N} iters={ITERS}: max_abs_err {err:.3e} (tol {KERNEL_ATOL:g}), "
            f"|ref| max {float(ref.abs().max()):.3f}, kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by}) on {card}")
        if not (finite and err <= KERNEL_ATOL):
            log("FAIL: apgd_lanes disagrees with its plain version")
            ok = False
        del J, A, b, mu, active, x0, out, ref
        for R in (ROWS, ALL_ROWS):
            A, b, mu, active = envfirst_problem(torch, R, N, dev, R)
            out = k2(A, b, mu, active, ITERS)
            ref = contact_kernel.apgd_envfirst_plain(A, b, mu, active, ITERS)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            bound_ms, bound_by = envfirst_bound_ms(R, N, ITERS)
            st = dict(max_abs_err=err, ms=cuda_ms(torch, lambda: k2(A, b, mu, active, ITERS), 50),
                      plain_ms=cuda_ms(torch, lambda: contact_kernel.apgd_envfirst_plain(A, b, mu, active, ITERS), 10),
                      bound_ms=bound_ms, bound_by=bound_by)
            # the training path's shape (R = 12) is the kernel's entry; every row (R = 38) rides along
            stats["apgd_envfirst"].update(st if R == ROWS else {f"r{R}": st})
            log(f"apgd_envfirst R={R} N={N} iters={ITERS}: max_abs_err {err:.3e} (tol {KERNEL_ATOL:g}), "
                f"|ref| max {float(ref.abs().max()):.3f}, kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, "
                f"bound {bound_ms * 1e3:.2f} us ({bound_by}) on {card}")
            if not (bool(torch.isfinite(out).all()) and err <= KERNEL_ATOL):
                log(f"FAIL: apgd_envfirst disagrees with its plain version at R={R}")
                ok = False
            del A, b, mu, active, out, ref

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
        for name, solve in (("kernel", k1), ("plain", contact_kernel.apgd_lanes_plain)):
            lanes.contact_solve = solve
            outs[name], _ = lanes.control_step_batched(env.sim_params, state.sim, pd, env.decimation,
                                                       paramsT=env.paramsT)
        lanes.contact_solve = k1
        torch.cuda.synchronize()
        worst, step_ok = compare_steps(torch, outs, STEP_RTOL)
        ok = ok and step_ok
        in_contact = int((outs["plain"].contact_forces.abs().sum((1, 2)) > 0).sum())
        log(f"one lanes control step at {NUM_ENVS} envs ({in_contact} with contact impulses), kernel vs "
            f"plain solve: max relative diff {worst:.3e} (tol {STEP_RTOL:g})")
        if in_contact < NUM_ENVS // 2:
            log("FAIL: too few envs in contact for the comparison to test the solve")
            ok = False
        del env, actor, state, obs, outs

    with phase("substep-envfirst"):
        cfg = compose(TRAIN_SELECTIONS, TRAIN_OVERRIDES + ["simulator.config.solver=pallas"])
        env = MotionTrackingEnv(cfg, NUM_ENVS, device=dev, seed=0)
        state = env.reset_to_start(env.init_state())
        obs, state.history = env.compute_observations(state)
        zero = torch.zeros((NUM_ENVS, env.num_actions), device=dev)
        with torch.no_grad():
            # hold the default pose for a few steps: the soles reach the ground
            for _ in range(SETTLE_STEPS):
                state, obs, _, _, _ = env.step(state, zero)
        target = state.default_dof_pos
        kp, kd = state.kp_scale * env.p_gains, state.kd_scale * env.d_gains

        def pd0(st):
            return torch.clamp(kp * (target - st.dof_pos) - kd * st.dof_vel, -env.torque_limits, env.torque_limits)

        eng = env.engine
        outs = {}
        for name, solve in (("kernel", k2), ("plain", contact_kernel.apgd_envfirst_plain)):
            eng.contact_solve = solve
            outs[name], _ = eng.control_step_batched(env.sim_params, state.sim, pd0, env.decimation,
                                                     paramsT=env.paramsT)
        eng.contact_solve = k2
        torch.cuda.synchronize()
        worst, step_ok = compare_steps(torch, outs, STEP_RTOL)
        ok = ok and step_ok
        in_contact = int((outs["plain"].contact_forces.abs().sum((1, 2)) > 0).sum())
        log(f"one env-first control step at {NUM_ENVS} envs ({in_contact} with contact impulses), kernel vs "
            f"plain solve: max relative diff {worst:.3e} (tol {STEP_RTOL:g})")
        if in_contact < NUM_ENVS // 2:
            log("FAIL: too few envs in contact for the comparison to test the solve")
            ok = False
        del cfg, env, state, obs, outs

    with phase("serving"):
        res = count("serving", lambda: batch_eval.episode_ratio(CKPT, NUM_ENVS, device=dev))
        log("episode_ratio: " + json.dumps(res))
        expect_launches("serving", {"apgd_lanes": 4 * res["episode_steps"], "apgd_envfirst": 0})
        if res["nonfinite_env_steps"] != 0:
            log(f"FAIL: {res['nonfinite_env_steps']} env-steps ended non-finite")
            ok = False
        if not abs(res["ratio"] - JAX_RATIO) <= RATIO_BAND:
            log(f"FAIL: ratio {res['ratio']:.6f} outside {JAX_RATIO} +- {RATIO_BAND}")
            ok = False
        log(f"control_steps_per_sec {res['control_steps_per_sec']:.3f} at {NUM_ENVS} envs on {card}")
    torch.cuda.empty_cache()

    trained = {}
    for solver, kernel in (("lanes", "apgd_lanes"), ("pallas", "apgd_envfirst")):
        path, iters = f"train-{solver}", TRAIN_ITERS[solver]
        with phase(path):
            base = os.path.join(REPO, "build", "chip_smoke", solver)
            shutil.rmtree(base, ignore_errors=True)
            # the training CLI, logging every iteration (logging_interval 5 -> 1)
            argv = TRAIN_SELECTIONS + TRAIN_OVERRIDES + [
                f"simulator.config.solver={solver}", f"algo.config.num_learning_iterations={iters}",
                "algo.config.logging_interval=5", f"base_dir={base}"]
            algo, ts, logs = count(path, lambda: train.main(argv))
            other = "apgd_envfirst" if kernel == "apgd_lanes" else "apgd_lanes"
            expect_launches(path, {kernel: 96 * iters, other: 0})
            bad = sorted({k for it_log in logs for k, v in it_log.items() if v != v or abs(v) == float("inf")})
            if bad or len(logs) != iters:
                log(f"FAIL: {path}: {len(logs)} logged iterations, non-finite values {bad}")
                ok = False
            timed = logs[1:]           # the first iteration warms up cuBLAS and the allocator
            steps = algo.num_steps * algo.env.num_envs
            eps = steps * len(timed) / sum(x["rollout_s"] + x["update_s"] for x in timed)
            log(f"{path}: train_env_steps_per_sec {eps:.1f} at {algo.env.num_envs} envs on {card} "
                f"(iterations 2-{iters}); per iteration rollout/update seconds "
                + ", ".join(f"{x['rollout_s']:.3f}/{x['update_s']:.3f}" for x in logs))
            log(f"{path}: last log: rew/step {logs[-1]['Train/mean_step_reward']:.4f}, "
                f"kl {logs[-1]['Loss/kl']:.4f}, lr {logs[-1]['Loss/lr']:.2e}, "
                f"value loss {logs[-1]['Loss/value']:.4f}")
            ckpts = glob.glob(os.path.join(base, "*", "*", "ckpt", f"model_{iters}.pkl"))
            trained[solver] = (algo, ts, ckpts)
        torch.cuda.empty_cache()

    with phase("update"):
        algo, ts, _ = trained["lanes"]
        cpu = cpu_copy(algo, ts, torch)
        # the configured initial lr, so that the step moves the weights (the
        # adaptive lr of the trained state sits at its floor of 1e-5)
        ts.lr, cpu.lr = (torch.tensor(float(algo.config.actor_learning_rate), device=d) for d in (dev, "cpu"))
        batch = update_batch(torch, algo, cpu, UPDATE_SAMPLES)
        m_cpu = algo._minibatch_update(cpu, batch)
        m_gpu = algo._minibatch_update(ts, {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        worst = 0.0
        for net in ("actor", "critic"):
            for (name, a), (_, c) in zip(getattr(ts, net).named_parameters(), getattr(cpu, net).named_parameters()):
                worst = max(worst, float((a.detach().cpu() - c.detach()).abs().max()))
        lr_same = float(ts.lr) == float(cpu.lr)
        log(f"one minibatch update of {UPDATE_SAMPLES} samples, card vs CPU: params max abs diff "
            f"{worst:.3e} (tol {UPDATE_ATOL:g}), lr {float(ts.lr):.3e} vs {float(cpu.lr):.3e}, "
            f"kl {float(m_gpu['kl']):.6f} vs {float(m_cpu['kl']):.6f}")
        if not (worst <= UPDATE_ATOL and lr_same):
            log("FAIL: the card's minibatch update disagrees with the CPU's")
            ok = False

    with phase("checkpoint"):
        # the `.pkl` the training CLI wrote at its end, read back
        algo, ts, ckpts = trained["pallas"]
        if len(ckpts) != 1:
            raise RuntimeError(f"want one final checkpoint of train-pallas, found {ckpts}")
        payload = load_checkpoint_payload(ckpts[0])
        actor = from_flax(payload["actor_params"], actor_from_config(algo.full_config, algo.actor_dim, algo.num_act))
        critic = from_flax(payload["critic_params"],
                           critic_from_config(algo.full_config, algo.critic_dim, algo.num_rew))
        same = all(bool(torch.equal(a.cpu(), b.cpu())) for a, b in
                   zip([*actor.parameters(), *critic.parameters()], [*ts.actor.parameters(), *ts.critic.parameters()]))
        log(f"checkpoint {os.path.relpath(ckpts[0], REPO)}: iteration {payload['iteration']}, lr "
            f"{payload['lr']:.3e}, params read back {'identical' if same else 'DIFFERENT'}; "
            f"flax keys {sorted(flax_params(actor)['params'])}")
        if not (same and payload["iteration"] == TRAIN_ITERS["pallas"]):
            log("FAIL: the checkpoint does not read back")
            ok = False

    if not ok:
        log("chip_smoke: FAILED")
        return 1
    with phase("report"):
        sources = {"apgd_lanes": ("pbhc_tpu_torch/csrc/apgd_lanes.cu", "pbhc_tpu/sim/pallas_contact.py:112"),
                   "apgd_envfirst": ("pbhc_tpu_torch/csrc/apgd_envfirst.cu", "pbhc_tpu/sim/pallas_contact.py:37")}
        kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                        launches=sum(launches[name].values()),
                        launches_by_path={p: n for p, n in launches[name].items() if n},
                        library_ms=None, **stats[name])
                   for name, (src, rep) in sources.items()]
        log(f"total seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
