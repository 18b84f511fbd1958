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
  `apgd_envfirst`);
- KungfuBot2 serving: `episode_ratio` on the committed 23-DoF teacher
  (`GeneralTrackingEnv`, Conv1d mimic networks) at 2048 envs over the
  whole clip (kernel 1);
- KungfuBot2 training: the training CLI on the 23-DoF teacher selection set
  (PPOMimic, RL + DAgger) and the student selection set distilled from the
  committed teacher, 2048 envs, random weights from seed 0 (kernel 1), and
  a resume of the teacher run from its checkpoint;
- terrain serving: `episode_ratio` on the committed heightfield-terrain run
  `terrain_walk_v3` at its 4096 envs over the whole clip (kernel 1);
- terrain training: the training CLI on the v1 selection set with
  `terrain=locomotion` at 4096 envs, once per solver (kernels 1 and 2);
- evaluation: `pbhc_tpu_torch.eval_agent.main`, the evaluation CLI, on a copy
  of the side-kick run under `build/chip_smoke/` (the deploy export, the
  deterministic rollout with randomness off, the metric families; kernel 1);
- the per-env engine: `episode_ratio` of the side-kick at 4096 envs with
  `solver: apgd` (plain PyTorch solves, no kernel, as in JAX);
- the options no committed run selects: soft dynamic correction on the lanes
  engine, KungfuBot2 training with MoE backbones, MHPPO training with
  phase-aware networks (kernel 1);
- deploy: `pbhc_tpu_torch.deploy.export.main(["student", ...])`, the export
  CLI, on the committed KungfuBot2 student, then that student served at its
  own 2048 envs (kernel 1) with env 0's deploy inputs rebuilt on the host by
  `StudentObsBuilder` and run by both host executors of the export, the
  side-kick's exports on the host executors, and the teleop hook of the env;
- the benchmark suite: `pbhc_tpu_torch.eval.benchmarks.main`, configs 2-5
  (walk tracking at 64 envs, horse-stance punch at 4096, KungfuBot2 29-DoF
  over a merged library of three 23-DoF clips at 2048, 29-DoF walk at 1024;
  kernel 1);
- env-axis data parallelism: the training CLI under 2 gloo ranks that share
  the card (2 x 2048 envs) and under a 1-rank nccl group (4096 envs), spawned
  by `pbhc_tpu_torch.parallel.mesh.run_ranks` (kernel 1);
- the offline motion pipeline: `retarget_smpl_joints` over 200 frames,
  `python -m pbhc_tpu_torch.motion.smpl_npz`, the contact mask and the
  stability filter on the card, and `eval_agent`'s `save_motion=true`;
- the options of the ported paths that no committed run selects:
  `contact_matvec_dtype` bfloat16 and float16 (kernel 1 in its reduced
  matvec modes: one control step each, and the side-kick served over its
  whole clip in bfloat16) and `parallel_serial_tau` on both batched
  solvers (kernels 1 and 2).
Phases, each announced when it starts and when it ends:

  build            - compile both kernels from `pbhc_tpu_torch/csrc/` (nvcc, sm_90a, in parallel)
  kernel           - each kernel vs its plain version at R = 12 and 38 rows (kernel 1 also at N = 2048,
                     1024 and 64, and in its bfloat16 and float16 matvec modes), with timings
  substep          - one lanes control step at 4096 envs, kernel 1 vs plain solve
  substep-allrows  - the same with `contact_cap: 0` (every row, R = 38)
  substep-envfirst - one env-first control step at 4096 envs, kernel 2 vs plain solve
  substep-29dof    - one lanes control step of the 29-DoF KungfuBot2 teacher config at 2048 envs,
                     kernel 1 vs plain solve
  substep-terrain  - one lanes control step of terrain_walk_v3 (heightfield) at 4096 envs, kernel 1
                     vs plain solve
  substep-apgd     - one per-env control step of the side-kick at 4096 envs, solver apgd, card vs CPU
  substep-pgs      - the same with solver pgs
  substep-sdc      - one lanes control step with soft dynamic correction (alpha 0.1) at 4096 envs,
                     kernel 1 vs plain solve
  substep-bf16     - one lanes control step of the side-kick at 4096 envs with
                     `contact_matvec_dtype: bfloat16`, kernel 1 in its bfloat16 mode vs the plain
                     solve in bfloat16 (4 launches in that mode)
  substep-f16      - the same in float16
  substep-pstau    - one control step at 4096 envs with `parallel_serial_tau` on, solver lanes and
                     solver pallas: finite, 4 launches of the solver's kernel, the `rao` bump on the
                     option's joints only
  serving          - the episode_ratio rollout; kernel launches counted from 0
  serving-kb2      - the KungfuBot2 teacher's episode_ratio rollout at 2048 envs; counted from 0
  serving-terrain  - terrain_walk_v3's episode_ratio rollout at 4096 envs; counted from 0
  serving-apgd     - the side-kick's episode_ratio rollout at 4096 envs with solver apgd; counted
                     from 0 (no kernel launches)
  serving-bf16     - the side-kick's episode_ratio rollout at 4096 envs with
                     `contact_matvec_dtype: bfloat16`; counted from 0 (kernel 1 in its bfloat16 mode)
  train-lanes      - the training CLI for 2 iterations, solver lanes; launches counted from 0
  train-pallas     - the training CLI for 2 iterations, solver pallas; launches counted from 0
  update           - one minibatch update on the card and on the CPU, same state and batch
  checkpoint       - read back the `.pkl` the train-pallas run wrote
  dp               - (a) one rollout of the train-lanes state split by env: its update on 2 gloo ranks
                     sharing the card against the one-process update (each tensor's distance over
                     its movement, lr; beside the one process with every minibatch's rows reversed
                     and on other permutations); (b) the training CLI
                     under those 2 ranks, 2 x 2048 envs, 2 iterations (launches counted from 0 per rank:
                     96 per iteration each; replicas bit-identical; rank 0's checkpoint read back);
                     (c) the same under a 1-rank nccl group at 4096 envs; (d) `parallel.dryrun` on
                     the card, 2 ranks x 4 envs sharing it; one JSON line {"dp": ...}
  train-terrain-lanes  - the training CLI with terrain=locomotion, 1 iteration, solver lanes
  train-terrain-pallas - the same with solver pallas
  train-phase      - the training CLI with phase-aware (sinusoidal) MHPPO networks, 1 iteration, lanes
  train-kb2-teacher - the training CLI, KungfuBot2 teacher, 2 iterations (RL + DAgger, then RL)
  train-kb2-student - the training CLI, KungfuBot2 student distilled from the committed teacher,
                     2 iterations; its history encoder must stay the teacher's
  update-kb2       - one PPOMimic RL minibatch update on the card and on the CPU
  resume           - the teacher run resumed from its checkpoint to 3 iterations in all
  train-kb2-moe    - the training CLI, KungfuBot2 teacher with MoE actor and critic, 1 iteration
                     (RL + DAgger); the load-balance loss logged
  update-kb2-moe   - one PPOMimic RL minibatch update of the MoE nets on the card and on the CPU
  eval-agent       - the evaluation CLI on a copy of the side-kick run with save_motion=true; its
                     export against the CPU's, its completion ratio and families against the JAX
                     package's, its motion clip read back in the JAX package's schema
  deploy           - the student export on the card against the CPU's and the JAX package's hash;
                     the student's deploy chain over 100 control steps at 2048 envs (launches counted
                     from 0); the side-kick's host executors against its actor on the card; the teleop
                     hook at 4096 envs; the host cores' tick; one JSON line {"deploy": ...}
  suite            - the benchmark suite's configs 2-5 (`pbhc_tpu_torch.eval.benchmarks`) at 64, 4096,
                     2048 and 1024 envs, 30 warm-up and 30 timed steps each (launches counted from 0
                     per config: 4 per step); config 4's library merged by `motion/package.merge`; one
                     JSON line per config and one {"suite": ...} line
  motion           - the retarget fit of 200 frames at 600 iterations (the committed clip's joints and
                     synthetic ones) against the JAX package's errors, 50 iterations card vs CPU, the
                     motion tools' FK, contact mask and stability filter card vs CPU, the smpl_npz CLI
                     on a seeded smpl.npz read back by the port's reader and MotionLib; one JSON line
                     {"motion": ...}
  report           - the `kernels` JSON line, the card line, the final result line

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It needs one CUDA card and exits non-zero, printing no result, if any phase
fails or no card is present. It imports no JAX and nothing of `pbhc_tpu`.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import glob
import json
import os
import shutil
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
TRAIN_ITERS = {"lanes": 2, "pallas": 2}   # lanes cut from 3 to 2 when the KungfuBot2 phases came
UPDATE_SAMPLES = 24576   # one minibatch of the training config: 24 steps x 4096 envs / 4
KB2_CKPT = "artifacts/kb2_teacher23_r3/ckpt/model_24000.pkl"
KB2_ENVS = 2048      # num_envs of the committed KungfuBot2 runs
KB2_MOTION = "robot.motion.motion_file=assets/motions/g1_ue_walk_23dof.pkl"
KB2_SELECTIONS = {role: ["exp=general_tracking", "robot=g1_23dof_student", f"obs=general_tracking_{role}",
                         "rewards=general_tracking", "domain_rand=main", "simulator=tpu"]
                  for role in ("teacher", "student")}
KB2_ITERS = 2        # iteration 0 runs RL + DAgger (dagger_update_freq 20), iteration 1 RL only
KB2_UPDATE_SAMPLES = 12288   # one PPOMimic minibatch: 24 steps x 2048 envs / 4
TERRAIN_CKPT = "artifacts/terrain_walk_v3/ckpt/model_6500.pkl"   # heightfield run, 4096 envs
TERRAIN_SELECTIONS = TRAIN_SELECTIONS + ["terrain=locomotion"]
TERRAIN_ITERS = 1    # cut from 2 when the per-env and option phases came: they repeat train-lanes/-pallas
                     # with a heightfield lookup, so one (untimed) iteration checks the path
EVAL_RUN = "kb1_side_kick"
PER_ENV = ["simulator.config.solver=apgd"]          # the per-env engine, as `batch_eval` overrides it
SDC = ["env.config.soft_dynamic_correction.enable=true", "env.config.soft_dynamic_correction.alpha=0.1",
       "env.config.soft_dynamic_correction.type=deter"]
MOE = ["algo.config.module_dict.actor.layer_config.type=MoEMLP",
       "algo.config.module_dict.critic.layer_config.type=MoEMLP"]
PHASE = ["algo.config.phase_embed.type=Sinusoidal"]
# randomness off (the set of tests/test_torch_env.py): the eval rollout is
# then deterministic, and its completion ratio comparable with the JAX one's
EVAL_OFF = ["domain_rand.push_robots=false", "domain_rand.randomize_torque_rfi=false",
            "domain_rand.use_rao=false", "domain_rand.randomize_ctrl_delay=false",
            "domain_rand.randomize_pd_gain=false", "domain_rand.randomize_rfi_lim=false",
            "domain_rand.randomize_link_mass=false", "domain_rand.randomize_link_inertia=false",
            "domain_rand.randomize_base_com=false", "domain_rand.randomize_friction=false",
            "obs.noise_scales.base_ang_vel=0", "obs.noise_scales.dof_pos=0",
            "obs.noise_scales.dof_vel=0", "obs.noise_scales.projected_gravity=0"]

# Tolerances (each stated with its reason):
# - kernel vs plain solve: the two sum the 36-term matvecs in different
#   orders (and the kernel fuses multiply-adds); 16 momentum iterations keep
#   the f32 difference far below 1e-4, the repo's own kernel-parity bound
#   (tests/test_pallas_contact.py::test_lanes_kernel_matches_xla_apgd).
KERNEL_ATOL = 1e-4
# - kernel 1's bfloat16 and float16 matvec modes vs the plain version in the
#   same mode: the two f32 momentum points differ by an ulp (summation order,
#   fused multiply-adds), and such an ulp can round y to the neighbouring
#   bfloat16 / float16 value. One such flip moves an impulse by at most about
#   one bfloat16 ulp of the largest |y| (2^-7 x ~3 = 2.3e-2 on these
#   problems); the flips seen move a few impulses by up to 1.5e-3 (eval/
#   kernel_bench.py, R = 12, N = 4096, NVIDIA H100 80GB HBM3, 700 W). Another
#   product rule moves every impulse (its mean difference 1e-5 to 1e-4). So:
#   max abs 1e-2 and mean abs 3e-6 (the mean bound tests/test_torch_engine_
#   lanes.py holds the plain version to JAX by).
MV_ATOL, MV_MEAN_ATOL = 1e-2, 3e-6
# the kernels of the `kernels` line: kernel 1 in each matvec mode, kernel 2
LANES_NAMES = {"float32": "apgd_lanes", "bfloat16": "apgd_lanes_bf16", "float16": "apgd_lanes_f16"}
KERNEL_NAMES = (*LANES_NAMES.values(), "apgd_envfirst")
# - one control step with kernel vs plain solve: the solve's f32 noise passes
#   through 4 substeps; a relative 1e-3 of each field's scale is 10x tighter
#   than the repo's own lanes-parity bound (1e-2 over 25 control steps).
STEP_RTOL = 1e-3
# - the same in a reduced matvec mode: the rounding flips above pass through
#   4 substeps, and in the envs they hit, contacts and light links amplify
#   them (the plain version against itself with another summation order, the
#   side-kick at 1024 envs on the CPU: an env's largest relative difference
#   up to 0.11 in bfloat16, 0.33 in float16, in a quarter of the envs above
#   1e-3). The median over the envs stays low: 4.5e-4 (bfloat16) and 1.8e-4
#   (float16) there, against 3.1e-3 to 3.6e-3 for a bfloat16 solve that
#   rounds the product or stays in float32; kernel vs plain at 4096 envs on an
#   H100 (NVIDIA H100 80GB HBM3, 700 W): 4.8e-4 and 1.6e-4, the largest env
#   0.28 and 0.13. So the gate is the median env's largest relative
#   difference, at most 1e-3.
MV_STEP_MEDIAN_RTOL = 1e-3
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
# - KungfuBot2 serving ratio: the JAX package's own figure for the committed
#   23-DoF teacher at 2048 envs on the CPU (python -m pbhc_tpu.eval.batch_eval
#   checkpoint=artifacts/kb2_teacher23_r3/ckpt/model_24000.pkl mode=ratio
#   num_envs=2048, see PERF.md: ratio_std 0.103, so the mean's standard error
#   is 0.0023). The port draws its domain randomisation and observation noise
#   from other random streams, so two runs differ by ~0.003 from sampling
#   alone; the band of 0.02 is six times that, as RATIO_BAND is for the
#   side-kick, and fails a policy or env that loses 2% more of the clip.
KB2_JAX_RATIO = 0.9878615475772472
KB2_RATIO_BAND = 0.02
# - terrain serving ratio: the JAX package's own figure for terrain_walk_v3 at
#   4096 envs on the CPU (JAX_PLATFORMS=cpu python -m pbhc_tpu.eval.batch_eval
#   checkpoint=artifacts/terrain_walk_v3/ckpt/model_6500.pkl mode=ratio
#   num_envs=4096, from the repository root, see PERF.md: ratio_std 0.158,
#   so the mean's standard error is 0.0025). The port draws its randomisation
#   from other streams; the band of 0.02 is eight times that error, as for
#   the other serving phases.
TERRAIN_JAX_RATIO = 0.9020365168539326
TERRAIN_RATIO_BAND = 0.02
# - per-env serving ratio: the JAX package's own figure for the side-kick
#   checkpoint at 4096 envs with solver apgd on the CPU (JAX_PLATFORMS=cpu
#   python -m pbhc_tpu.eval.batch_eval
#   checkpoint=artifacts/kb1_side_kick/ckpt/model_10500.pkl mode=ratio
#   num_envs=4096 simulator.config.solver=apgd, see PERF.md: ratio_std
#   0.034); the same band as the lanes figure of this checkpoint.
APGD_JAX_RATIO = 0.9973456899726432
APGD_RATIO_BAND = 0.02
# - bfloat16 serving ratio: the JAX package's own figure for the side-kick
#   checkpoint at 4096 envs with the bfloat16 matvec on the CPU
#   (JAX_PLATFORMS=cpu python -m pbhc_tpu.eval.batch_eval
#   checkpoint=artifacts/kb1_side_kick/ckpt/model_10500.pkl mode=ratio
#   num_envs=4096 simulator.config.contact_matvec_dtype=bfloat16, 13 min 15 s
#   on the CPU, ratio_std 0.031); the same band as the float32 figure.
BF16 = ["simulator.config.contact_matvec_dtype=bfloat16"]
BF16_JAX_RATIO = 0.9977731415719697
BF16_RATIO_BAND = 0.02
PSTAU = ["domain_rand.parallel_serial_tau.enable=true"]
# - eval-agent: the JAX package's own figures for the side-kick checkpoint
#   with EVAL_OFF on the CPU (JAX_PLATFORMS=cpu python -m pbhc_tpu.eval_agent
#   checkpoint=<copy of artifacts/kb1_side_kick>/ckpt/model_10500.pkl
#   <EVAL_OFF>, see PERF.md): completion 1.0, E_mpbpe 66.35258483886719 mm,
#   E_mpjpe 827.0711669921875. The port on the CPU gives 66.36317 and
#   827.11987 (1.6e-4 and 5.9e-5 relative): the families average a 296-step
#   closed-loop rollout, through which the f32 noise of the two packages
#   (and of the card against the CPU: other summation orders, the contact
#   kernel's 1e-4) grows, and a rollout that meets a contact event (a step
#   not continuous in the state) parts there: the horse-stance clip's
#   families differ by up to 0.9% between the packages on the CPU
#   (tests/test_torch_eval.py). The band of 2% relative covers that, and a
#   rollout that tracks worse (a foot that slips, a policy fed wrong
#   observations) moves these families by tens of percent.
EVAL_JAX_COMPLETION = 1.0
EVAL_JAX_FAMILIES = {"E_mpbpe": 66.35258483886719, "E_mpjpe": 827.0711669921875}
EVAL_REL_BAND = 0.02
# - deploy: the committed KungfuBot2 student, exported by the JAX package
#   (python -m pbhc_tpu.deploy.export student <STUDENT_CKPT> <out>): the
#   SHA-256 of its ONNX bytes (tests/test_torch_deploy.py pins it on the CPU)
STUDENT_CKPT = "artifacts/kb2_student23_r3/ckpt/model_8000.pkl"
STUDENT_ONNX_SHA256 = "7c90c7627fe76981680fdb4609000d4de4cbba82b4d6197b4e2adb01343457f5"
DEPLOY_STEPS = 100
DEPLOY_MIN_COMPARED = 50
# - the builder's deploy inputs against the env's row 0: 2e-4, the JAX
#   package's own bound (tests/test_student_obs.py): the builder interpolates
#   the reference on the host in float64 and normalises its quaternions, the
#   env in float32 on the card.
DEPLOY_OBS_ATOL = 2e-4
# - each host executor against the port's torch student on the card, on the
#   same deploy inputs: 1e-4 (cuDNN Conv1d and cuBLAS with TF32 off against
#   float32 numpy and the native core on the host, the kernel-parity bound);
#   the side-kick's executors against its `GaussianActor` on the card the same.
#   The executors on the built inputs against the rollout's own action (on the
#   env's inputs) also carry the inputs' difference, which the student
#   amplifies (1.8e-4 from 1.4e-4, on the CPU and on the card): printed as
#   `chain_*`, not gated; the two gates above hold each link of that chain.
DEPLOY_ACT_ATOL = 1e-4
# the student run's observation noise and the randomisations of
# tests/test_torch_env.py::OFF off (tests/test_student_obs.py's noise list)
STUDENT_OFF = ["obs.noise_scales.base_ang_vel=0", "obs.noise_scales.dof_pos=0", "obs.noise_scales.dof_vel=0",
               "obs.noise_scales.roll_pitch=0"] + [o for o in EVAL_OFF if o.startswith("domain_rand.")]
# - phase dp: 2 data-parallel ranks (gloo, sharing the card) and the 1-rank
#   nccl group train DP_ITERS iterations each. The update of the rollout split
#   over the 2 ranks is held to the one-process update of the whole, tensor by
#   tensor, by the distance between the two over the distance the tensor moved:
#   at most DP_RTOL. Not by an absolute bound: over its 20 Adam steps the one
#   process parts from itself, given the same minibatches with their rows in
#   reverse, by up to ~1e-5 (Adam turns the rounding of gradients that cancel
#   into lr-sized steps), as the split does; three H100 runs read 5.96e-08,
#   1.332e-07 and 3.470e-05 against the 1e-5 bound that
#   tests/test_torch_parallel.py keeps on the CPU, where a fixed seeded batch
#   from a primed Adam state stays inside it. Both comparisons are printed
#   beside the same update on other permutations (other samples in every
#   minibatch, the size of a fault), which must part by more than DP_RTOL.
DP_WORLD = 2
DP_ITERS = 2
DP_RTOL = 2e-2
# - phase motion: the JAX package's own fits on the CPU (JAX_PLATFORMS=cpu
#   PYTHONPATH=.:tests python -c "from test_torch_retarget import
#   synthetic_joints; ...retarget_smpl_joints(load_g1_motion_model(), J,
#   iters=600)['retarget_mean_error_m']" with J the 200 frames of
#   Horse-stance_punch's smpl_joints, all zeros in every committed clip, and
#   J = synthetic_joints(200)); the smpl_npz CLI's fit is JAX's
#   `npz_to_clip(<write_smpl_npz(T=30)>, iters=600)`. The card is held within
#   2 mm of each (the fit's 600 Adam steps part the float32 paths: the port on
#   the CPU gives 0.0190947 and 0.0163541, 0.13 mm and 7 um off).
RETARGET_JAX_ERR_CLIP = 0.01896694116294384
RETARGET_JAX_ERR_SYNTH = 0.01634683459997177
SMPL_NPZ_JAX_ERR = 0.008459036238491535
RETARGET_ERR_BAND = 2e-3
RETARGET_MAX_ERR = 0.08
# - the fit on the card against the port on the CPU after 50 iterations:
#   1e-3 on every parameter. One float32 ulp of noise on the targets moves
#   them by up to 3.3e-5 on the CPU (measured over three draws); the card's
#   other summation orders are noise of that kind at every step; 1e-3 is 30
#   times that and a twentieth of one Adam step (lr 0.02).
RETARGET_CARD_CPU_ATOL = 1e-3
# - the motion tools' FK on the card against the CPU: 1e-5 m (float32 FK,
#   other summation orders); the contact mask built on it exactly.
MOTION_FK_ATOL = 1e-5
TELEOP = ["env.config.use_teleop_control=true", "env.config.teleop_port=0"]


def log(msg):
    print(msg, flush=True)


def reset_counts(ck):
    """Every launch count of the contact kernels (module `ck`) to 0."""
    ck.apgd_lanes.launches = ck.apgd_envfirst.launches = 0
    for mode in ck.apgd_lanes.mode_launches:
        ck.apgd_lanes.mode_launches[mode] = 0


def read_counts(ck):
    """{name in KERNEL_NAMES: launches since reset_counts}."""
    return {**{LANES_NAMES[mode]: n for mode, n in ck.apgd_lanes.mode_launches.items()},
            "apgd_envfirst": ck.apgd_envfirst.launches}


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    log(f"[phase {name}] start")
    yield
    log(f"[phase {name}] ok in {time.perf_counter() - t0:.1f} s")


def per_env_rel(torch, a, p):
    """Each env's largest difference of the control step `a` from `p`, over
    the fields, relative to the field's scale in `p` -> [N], on p's device."""
    fields = ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "dof_pos", "dof_vel", "body_pos",
              "contact_forces")
    n = p.root_pos.shape[0]
    return torch.stack([(getattr(a, f).to(getattr(p, f).device) - getattr(p, f)).abs().reshape(n, -1).amax(1)
                        / max(1.0, float(getattr(p, f).abs().max())) for f in fields]).amax(0)


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


def mimic_cpu_copy(algo, ts):
    """The net and optimizer states of a PPOMimic train state on the CPU."""
    out = algo.new_train_state(copy.deepcopy(ts.net).cpu())
    for src, dst in ((ts.opt, out.opt), (ts.hist_opt, out.hist_opt)):
        dst.load_state_dict(src.state_dict())
    return out


def mimic_update_batch(torch, algo, ts, cpu, n):
    """A seeded RL minibatch of `n` samples near the policy of `cpu` (see
    update_batch): the observations are the card env's over n / N control
    steps from `ts`'s env state under the deterministic history-latent
    action, the stored values the critic's, the stored mean the actor's
    moved by 0.01."""
    from pbhc_tpu_torch.agents.networks import gaussian_log_prob
    from pbhc_tpu_torch.agents.ppo_mimic import OBS_KEYS

    state, obs, seen = ts.env_state, ts.obs, []
    with torch.no_grad():
        while sum(o["actor_obs"].shape[0] for o in seen) < n:
            seen.append({k: obs[k].cpu() for k in OBS_KEYS})
            state, obs, _, _, _ = algo.env.step(state, ts.net.act(obs, True)[0])
        obs = {k: torch.cat([o[k] for o in seen])[:n] for k in OBS_KEYS}
        mean, std = cpu.net.act(obs, False)
        values = cpu.net.evaluate(obs)
    g = torch.Generator().manual_seed(2)
    rn = lambda *shape: torch.randn(shape, generator=g)
    mean = mean + 0.01 * rn(*mean.shape)
    actions = mean + std * rn(*mean.shape)
    return dict(obs, actions=actions, logp=gaussian_log_prob(mean, std, actions), mean=mean, std=std,
                values=values, returns=values + 0.3 * rn(*values.shape), advantages=rn(n))


def student_deploy_chain(torch, env, net, onnx, steps):
    """Roll the student `net` (deterministic, history latent) in `env` for
    `steps` control steps from clip start. At each step until env 0's first
    `done`, copy env 0's state to the host, build its three deploy inputs
    with `StudentObsBuilder` (`compensate_offsets=False`, fed by a
    `MotionHost` over the env's `MotionLib`), and run both host executors of
    the export `onnx` on them. Returns the steps compared and the largest
    differences: each input against the env's row 0 (`obs_*`); each
    executor against the torch student on the env's device on the same
    inputs (`exec_*`) and against the rollout's own action for env 0
    (`chain_*`, which also carries the inputs' difference)."""
    import numpy as np

    from pbhc_tpu_torch.deploy.export import StudentPolicy, student_meta
    from pbhc_tpu_torch.deploy.student_obs import MotionHost, StudentObsBuilder
    from pbhc_tpu_torch.eval import batch_eval
    from pbhc_tpu_torch.maths import rotations as rot

    builder = StudentObsBuilder(student_meta(env), MotionHost(env.motion_lib), compensate_offsets=False)
    executors = {"numpy": StudentPolicy(onnx), "native": StudentPolicy(onnx, native=True)}
    err = dict.fromkeys([f"obs_{k}" for k in ("actor_obs", "future_motion_targets", "prop_history")]
                        + [f"{kind}_{name}" for kind in ("exec", "chain") for name in executors], 0.0)
    compared, done_at = 0, None
    state, obs = batch_eval.start_episodes(env)
    host = lambda x: x.detach().cpu().numpy()
    with torch.no_grad():
        for i in range(steps):
            action = batch_eval.act_mean(net, obs)
            if done_at is None:
                sim = state.sim
                robot = type("Robot", (), dict(
                    q=host(sim.dof_pos[0]), dq=host(sim.dof_vel[0]), quat_xyzw=host(sim.root_quat[0]),
                    base_ang_vel_local=host(rot.quat_rotate_inverse(sim.root_quat[:1], sim.root_ang_vel[:1])[0]),
                    last_action=host(state.actions[0])))
                t = float(state.episode_length[0]) * env.dt + float(state.motion_start_times[0])
                feeds = builder.build(robot, t)
                for k, v in feeds.items():
                    err[f"obs_{k}"] = max(err[f"obs_{k}"], float(np.abs(v[0] - host(obs[k][0])).max()))
                on_card = host(net.act({k: torch.as_tensor(v, device=env.device) for k, v in feeds.items()},
                                       True)[0][0])
                for name, pol in executors.items():
                    a = pol(feeds)
                    err[f"exec_{name}"] = max(err[f"exec_{name}"], float(np.abs(a - on_card).max()))
                    err[f"chain_{name}"] = max(err[f"chain_{name}"], float(np.abs(a - host(action[0])).max()))
                compared += 1
            state, obs, _, done, _ = env.step(state, action)
            if done_at is None and bool(done[0]):
                done_at = i
    return dict(compared=compared, env0_done_at=done_at, **err)


def host_tick_us(fn, calls=1000):
    """Median wall time of one call of `fn()`, in microseconds, over `calls`
    calls after one warm-up call (the host clock: these run on the host)."""
    import statistics

    fn()
    ticks = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        ticks.append(time.perf_counter() - t0)
    return statistics.median(ticks) * 1e6



def _leaves(tree):
    """The arrays of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def synthetic_smpl_joints(T, seed=0):
    """SMPL joints [T,24,3] of a seeded pose sequence (smooth sinusoids about
    the upright root, walking forward) through the neutral skeleton's FK,
    floored and scaled to the G1 as `npz_to_clip` does: the recipe of
    tests/test_torch_retarget.py::synthetic_joints (the committed clips'
    `smpl_joints` are all zeros, a degenerate target)."""
    import numpy as np
    from scipy.spatial.transform import Rotation as sRot

    from pbhc_tpu_torch.motion.smpl_npz import smpl_fk

    rng = np.random.default_rng(seed)
    t = np.arange(T) / 30.0
    poses = np.zeros((T, 24, 3))
    poses[:, 0] = sRot.from_euler("xyz", [np.pi / 2, 0, np.pi]).as_rotvec()
    amp, freq, phase_ = rng.uniform(0, 0.4, (24, 3)), rng.uniform(0.3, 1.5, (24, 3)), rng.uniform(0, 6.3, (24, 3))
    poses[:, 1:] = (amp * np.sin(2 * np.pi * freq * t[:, None, None] + phase_))[:, 1:]
    j = smpl_fk(poses, np.stack([0.3 * t, np.zeros(T), np.full(T, 0.9)], 1))
    j[..., 2] -= j[:, [7, 8, 10, 11], 2].min()
    return (j * 0.85).astype(np.float32)


def write_smpl_npz(path, T):
    """A GVHMR-schema `smpl.npz` by tests/test_smpl_npz.py's `_write_npz`
    recipe: the upright rest pose, walking 1 m along x at 0.9 m height."""
    import numpy as np
    from scipy.spatial.transform import Rotation as sRot

    poses = np.zeros((T, 72))
    poses[:, :3] = sRot.from_euler("xyz", [np.pi / 2, 0, np.pi]).as_rotvec()
    trans = np.stack([np.linspace(0, 1.0, T), np.zeros(T), np.full(T, 0.9)], axis=1)
    np.savez(path, betas=np.zeros(10), gender="neutral", poses=poses, trans=trans, mocap_framerate=30.0)


def dp_rank(learn, train_argv):
    """One rank of phase dp, in a process group that `run_ranks` set up.
    `learn` (argv, state, rollout halves, permutations; or None): the v1
    update phase on this rank's half of a rollout. `train_argv`: the training
    CLI, its launches counted from 0. Returns numpy results."""
    import torch

    from pbhc_tpu_torch import train
    from pbhc_tpu_torch.agents.convert import flax_params
    from pbhc_tpu_torch.config.loader import compose, parse_cli
    from pbhc_tpu_torch.parallel.mesh import make_mesh
    from pbhc_tpu_torch.sim import contact_kernel

    out = {}
    if learn is not None:
        argv, state_path, half_paths, perms_path = learn
        cfg = compose(*parse_cli(argv))
        _, algo, ts = train.build(cfg, make_mesh(int(cfg.num_envs)))
        dev, rank = algo.device, algo.shard.rank
        state = torch.load(state_path, weights_only=False)
        ts.actor.load_state_dict(state["actor"])
        ts.critic.load_state_dict(state["critic"])
        ts.actor_opt.load_state_dict(state["actor_opt"])
        ts.critic_opt.load_state_dict(state["critic_opt"])
        ts.lr = state["lr"].to(dev)
        half = torch.load(half_paths[rank], map_location=dev, weights_only=False)
        perms = [p.to(dev) for p in torch.load(perms_path, weights_only=False)]
        t0 = time.perf_counter()
        ts, _ = algo.learn(ts, (None, half["obs"], half["traj"], {}), perms=perms)
        torch.cuda.synchronize()
        out["learn"] = {"params": [p.detach().cpu().numpy() for p in [*ts.actor.parameters(), *ts.critic.parameters()]],
                        "lr": float(ts.lr), "seconds": time.perf_counter() - t0}
        del algo, ts, half
        torch.cuda.empty_cache()
    reset_counts(contact_kernel)
    algo, ts, logs = train.main(train_argv)
    torch.cuda.synchronize()
    out["train"] = {"logs": logs, "launches": read_counts(contact_kernel),
                    "actor": flax_params(ts.actor), "critic": flax_params(ts.critic),
                    "local_envs": algo.env.num_envs, "world": algo.shard.world, "backend": algo.shard.backend}
    return out


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    from pbhc_tpu_torch import eval_agent, train
    from pbhc_tpu_torch.agents.convert import flax_params, from_flax
    from pbhc_tpu_torch.agents.networks import actor_from_config, critic_from_config
    from pbhc_tpu_torch.config.loader import Cfg, apply_overrides, compose, load_snapshot
    from pbhc_tpu_torch.deploy.export import export_policy
    from pbhc_tpu_torch.envs.general_tracking_env import GeneralTrackingEnv
    from pbhc_tpu_torch.envs.tracking_env import MotionTrackingEnv
    from pbhc_tpu_torch.eval import batch_eval, kernel_bench
    from pbhc_tpu_torch.sim import contact_kernel
    from pbhc_tpu_torch.utils import nvcc
    from pbhc_tpu_torch.utils.checkpoint import OPT_KEY, load_checkpoint_payload

    batch_eval.set_precision()
    dev = torch.device("cuda:0")
    card = kernel_bench.card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    k1, k2 = contact_kernel.apgd_lanes, contact_kernel.apgd_envfirst
    ok = True
    stats = {name: {} for name in KERNEL_NAMES}
    launches = {name: {} for name in KERNEL_NAMES}

    def count(path, fn):
        """Run `fn` with every launch count set to 0, then record them."""
        reset_counts(contact_kernel)
        out = fn()
        torch.cuda.synchronize()
        for name, n in read_counts(contact_kernel).items():
            launches[name][path] = n
        log(f"{path}: " + ", ".join(f"{name} launched {launches[name][path]}" for name in KERNEL_NAMES))
        return out

    def expect_launches(path, want):
        """Each kernel launched as `want` says on `path`, the unnamed ones not at all."""
        nonlocal ok
        for name in KERNEL_NAMES:
            if launches[name][path] != want.get(name, 0):
                log(f"FAIL: {path}: {name} launched {launches[name][path]} times, want {want.get(name, 0)}")
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
        for name, k in kernel_bench.KERNELS.items():
            # kernel 1 also at the KungfuBot2 paths' shape (R = 12, N = 2048),
            # and at the benchmark suite's smallest and 29-DoF widths (N = 64, 1024)
            shapes = [(ROWS, NUM_ENVS), (ALL_ROWS, NUM_ENVS)] + (
                [(ROWS, KB2_ENVS), (ROWS, 64), (ROWS, 1024)] if name == "apgd_lanes" else [])
            for R, N in shapes:
                args = k.problem(R, N, dev, R)
                out = k.wrapper(*args, ITERS)
                ref = k.plain(*args, ITERS)
                torch.cuda.synchronize()
                err, mean_err = float((out - ref).abs().max()), float((out - ref).abs().mean())
                bound_ms, bound_by = k.bound(R, N, ITERS)
                # ms: per launch over 50 launches back to back, CUDA events (the
                # host's launch cost shows there); ms_device: the kernel's own
                # device time, from a profiler trace of 50 launches
                st = dict(max_abs_err=err, mean_abs_err=mean_err,
                          ms=kernel_bench.cuda_ms(lambda: k.wrapper(*args, ITERS), 50),
                          ms_device=kernel_bench.device_ms(lambda: k.wrapper(*args, ITERS), 50, k.symbol),
                          plain_ms=kernel_bench.cuda_ms(lambda: k.plain(*args, ITERS), 10),
                          bound_ms=bound_ms, bound_by=bound_by, tile=contact_kernel.tile(k.symbol, R, k.mode))
                # the first paths' shape (R = 12, N = 4096) is the kernel's entry; every row
                # (R = 38) and the other widths (N = 2048, 1024, 64) ride along
                stats[name].update(st if (R, N) == (ROWS, NUM_ENVS) else {f"r{R}" if R != ROWS else f"n{N}": st})
                reduced = k.mode != "float32"
                tol = f"tol {MV_ATOL:g}, mean tol {MV_MEAN_ATOL:g}" if reduced else f"tol {KERNEL_ATOL:g}"
                log(f"{name} ({k.mode}) R={R} N={N} iters={ITERS}: max_abs_err {err:.3e}, mean {mean_err:.3e} "
                    f"({tol}), |ref| max {float(ref.abs().max()):.3f}, kernel {st['ms']:.5f} ms per launch back "
                    f"to back, {st['ms_device']:.5f} ms on the device, plain {st['plain_ms']:.5f} ms, "
                    f"bound {bound_ms * 1e3:.2f} us ({bound_by}), tile (E, P) = {st['tile']} on {card}")
                good = err <= MV_ATOL and mean_err <= MV_MEAN_ATOL if reduced else err <= KERNEL_ATOL
                if not (bool(torch.isfinite(out).all()) and good):
                    log(f"FAIL: {name} disagrees with its plain version at R={R}")
                    ok = False
                del args, out, ref

    def lanes_step_check(env, state, obs, act, rows, mode="float32", path=None):
        """One lanes control step of `env` (after SETTLE_STEPS under `act`),
        kernel 1 vs its plain version; every solve must have `rows` rows and
        run in the matvec mode `mode`. With `path`, the kernel's run is
        counted under it: 4 launches in that mode."""
        nonlocal ok
        with torch.no_grad():
            # settle onto the soles first: at clip time 0 no contact row is active
            for _ in range(SETTLE_STEPS):
                state, obs, _, _, _ = env.step(state, act(obs))
            mean = act(obs)
        target = mean * env.action_scales + state.default_dof_pos
        kp, kd = state.kp_scale * env.p_gains, state.kd_scale * env.d_gains

        def pd(st):
            return torch.clamp(kp * (target - st.dof_pos) - kd * st.dof_vel, -env.torque_limits, env.torque_limits)

        lanes = env.lanes_engine
        outs, seen = {}, []
        for name, solve in (("kernel", k1), ("plain", contact_kernel.apgd_lanes_plain)):
            def recorded(A, b, mu, active, x0, iters, mv_dtype="float32", solve=solve):
                seen.append((active.shape[0], mv_dtype))
                return solve(A, b, mu, active, x0, iters, mv_dtype)

            lanes.contact_solve = recorded
            pre = env._sdc_pre_fn(state, state.sim) if env.use_sdc else None
            step = lambda: lanes.control_step_batched(env.sim_params, state.sim, pd, env.decimation,
                                                      paramsT=env.paramsT, pre_substep_fn=pre)
            outs[name], _ = count(path, step) if path and name == "kernel" else step()
        lanes.contact_solve = k1
        torch.cuda.synchronize()
        if mode == "float32":
            worst, step_ok = compare_steps(torch, outs, STEP_RTOL)
            ok = ok and step_ok
            diff = f"max relative diff {worst:.3e} (tol {STEP_RTOL:g})"
        else:
            rel = per_env_rel(torch, outs["kernel"], outs["plain"])
            q = torch.quantile(rel, torch.tensor([0.5, 0.9, 0.99], device=rel.device)).tolist()
            diff = (f"each env's largest relative diff: median {q[0]:.3e} (tol {MV_STEP_MEDIAN_RTOL:g}), 90% "
                    f"{q[1]:.3e}, 99% {q[2]:.3e}, max {float(rel.max()):.3e}")
            if not (bool(torch.isfinite(rel).all()) and q[0] <= MV_STEP_MEDIAN_RTOL):
                log(f"FAIL: the {mode} control step's median env parts from the plain solve's")
                ok = False
        n = env.num_envs
        in_contact = int((outs["plain"].contact_forces.abs().sum((1, 2)) > 0).sum())
        log(f"one lanes control step at {n} envs, {env.nd} DoF, R = {sorted({r for r, _ in seen})} rows, matvec "
            f"{sorted({m for _, m in seen})} ({in_contact} envs with contact impulses), kernel vs plain solve: {diff}")
        if in_contact < n // 2:
            log("FAIL: too few envs in contact for the comparison to test the solve")
            ok = False
        if set(seen) != {(rows, mode)}:
            log(f"FAIL: the step solved with (R, matvec) = {sorted(set(seen))}, want {(rows, mode)}")
            ok = False
        if path:
            expect_launches(path, {LANES_NAMES[mode]: env.decimation})

    def side_kick_step_check(overrides, rows, mode="float32", path=None):
        env, actor, _ = batch_eval.load(CKPT, NUM_ENVS, overrides, device=dev)
        state, obs = batch_eval.start_episodes(env)
        lanes_step_check(env, state, obs, lambda o: actor(o["actor_obs"])[0], rows, mode, path)

    with phase("substep"):
        side_kick_step_check((), ROWS)

    with phase("substep-allrows"):
        # contact_cap 0 (EngineOptions' default) solves every row of the model
        side_kick_step_check(("simulator.config.contact_cap=0",), ALL_ROWS)

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

    with phase("substep-29dof"):
        # the 29-DoF KungfuBot2 teacher run's config (21 spheres, 17 pairs,
        # R = 12 with its caps), holding the default pose from clip start
        cfg = Cfg.wrap(apply_overrides(load_snapshot("kb2_teacher29_r5"), [f"num_envs={KB2_ENVS}"]))
        env = GeneralTrackingEnv(cfg, KB2_ENVS, device=dev, seed=0)
        state, obs = batch_eval.start_episodes(env)
        zero = torch.zeros((KB2_ENVS, env.num_actions), device=dev)
        lanes_step_check(env, state, obs, lambda o: zero, ROWS)
        del cfg, env, state, obs
        torch.cuda.empty_cache()

    with phase("substep-terrain"):
        # the heightfield run under its own policy: contacts on rough and
        # obstacle tiles 29-181 m from the world origin
        env, actor, _ = batch_eval.load(TERRAIN_CKPT, NUM_ENVS, device=dev)
        if env.terrain is None or tuple(env.engine.terrain_hf.shape) != (1300, 2100):
            log("FAIL: substep-terrain: the run did not install its heightfield")
            ok = False
        state, obs = batch_eval.start_episodes(env)
        lanes_step_check(env, state, obs, lambda o: actor(o["actor_obs"])[0], ROWS)
        del env, actor, state, obs
        torch.cuda.empty_cache()

    def per_env_step_check(path, solver):
        """One per-env control step of the side-kick at 4096 envs (after
        SETTLE_STEPS under its policy on the card) on the card and on the CPU,
        from the same state with the same PD torques; no kernel launches. An
        env whose contact starts a substep early or late on one device jumps
        (tests/test_torch_terrain.py): an env beyond the gate must be one whose
        CPU step jumps (a joint velocity by more than 2e-3 rad/s) when its root
        is nudged by 1e-5 m, and at most an eighth of the envs may be."""
        nonlocal ok
        from pbhc_tpu_torch.sim.engine import Engine, tree_map

        env, actor, _ = batch_eval.load(CKPT, NUM_ENVS, [f"simulator.config.solver={solver}"], device=dev)
        if env.physics != "per_env":
            log(f"FAIL: {path}: solver {solver} did not take the per-env engine")
            ok = False
        state, obs = batch_eval.start_episodes(env)
        with torch.no_grad():
            for _ in range(SETTLE_STEPS):
                state, obs, _, _, _ = env.step(state, actor(obs["actor_obs"])[0])
            mean = actor(obs["actor_obs"])[0]
        target = mean * env.action_scales + state.default_dof_pos
        kp, kd = state.kp_scale * env.p_gains, state.kd_scale * env.d_gains

        def pd_on(device):
            t, p_, d_, lim = (x.to(device) for x in (target, kp, kd, env.torque_limits))
            return lambda st: torch.clamp(p_ * (t - st.dof_pos) - d_ * st.dof_vel, -lim, lim)

        cpu_engine = Engine(env.sim_model, env.engine.opt, device="cpu")
        to_cpu = lambda x: x.cpu()
        cpu_params, cpu_sim = tree_map(to_cpu, env.sim_params), tree_map(to_cpu, state.sim)
        t0 = time.perf_counter()
        card_out = count(path, lambda: env.engine.control_step(env.sim_params, state.sim, pd_on(dev),
                                                               env.decimation)[0])
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_out, _ = cpu_engine.control_step(cpu_params, cpu_sim, pd_on("cpu"), env.decimation)
        cpu_s = time.perf_counter() - t0
        expect_launches(path, {"apgd_lanes": 0, "apgd_envfirst": 0})
        rel = per_env_rel(torch, card_out, cpu_out)
        far = rel > STEP_RTOL
        jumps = torch.zeros_like(far)
        if far.any():
            for dz in (1e-5, -1e-5):
                rp = cpu_sim.root_pos.clone()
                rp[:, 2] += dz
                nudged, _ = cpu_engine.control_step(cpu_params, dataclasses.replace(cpu_sim, root_pos=rp),
                                                    pd_on("cpu"), env.decimation)
                jumps |= (nudged.dof_vel - cpu_out.dof_vel).abs().amax(1) > 2e-3
        worst = float(rel[~far].max()) if bool((~far).any()) else float("nan")
        in_contact = int((cpu_out.contact_forces.abs().sum((1, 2)) > 0).sum())
        log(f"{path}: one per-env control step at {NUM_ENVS} envs ({in_contact} with contact impulses), card vs "
            f"CPU: max relative diff {worst:.3e} over {int((~far).sum())} envs (tol {STEP_RTOL:g}), "
            f"{int(far.sum())} envs beyond it (largest {float(rel.max()):.3e}), of which {int((far & jumps).sum())} "
            f"jump on the CPU under a 1e-5 m nudge; {card_s:.3f} s on {card} (first call), {cpu_s:.3f} s on the CPU")
        if bool((far & ~jumps).any()) or int(far.sum()) > NUM_ENVS // 8 or not bool(torch.isfinite(rel).all()):
            log(f"FAIL: {path}: the card's step parts from the CPU's where the CPU's step is continuous")
            ok = False
        if in_contact < NUM_ENVS // 2:
            log("FAIL: too few envs in contact for the comparison to test the solve")
            ok = False
        torch.cuda.empty_cache()

    with phase("substep-apgd"):
        per_env_step_check("substep-apgd", "apgd")

    with phase("substep-pgs"):
        per_env_step_check("substep-pgs", "pgs")

    with phase("substep-sdc"):
        # soft dynamic correction pulls every substep towards the reference
        # through the lanes engine's pre-substep hook
        side_kick_step_check(tuple(SDC), ROWS)

    for mode in ("bfloat16", "float16"):
        # the side-kick config names `lanes_contact_kernel: xla`: the solve
        # runs in the dtype, as JAX's XLA `_apgd` does
        path = {"bfloat16": "substep-bf16", "float16": "substep-f16"}[mode]
        with phase(path):
            side_kick_step_check((f"simulator.config.contact_matvec_dtype={mode}",), ROWS, mode, path)
        torch.cuda.empty_cache()

    with phase("substep-pstau"):
        # `parallel_serial_tau` on both batched solvers (as in JAX: the `rao`
        # bump at reset, no torque injection). The reset's first draw of the
        # episodic randomisation, against the same env's without the option
        # (both from seed 0): the bump lands on the option's joints only
        for solver, kernel, physics in (("lanes", "apgd_lanes", "lanes"), ("pallas", "apgd_envfirst", "batched")):
            path = f"substep-pstau-{solver}"
            rao = {}
            for name, extra in (("plain", []), ("pstau", PSTAU)):
                cfg = compose(TRAIN_SELECTIONS, TRAIN_OVERRIDES + [f"simulator.config.solver={solver}", *extra])
                env = MotionTrackingEnv(cfg, NUM_ENVS, device=dev, seed=0)
                rao[name] = env._episodic_dr(NUM_ENVS)[3]
            joints = list(env.dr.parallel_serial_tau.joint_idx)
            moved = (rao["pstau"] != rao["plain"]).any(0).nonzero()[:, 0].tolist()
            state = env.reset_to_start(env.init_state())
            obs, state.history = env.compute_observations(state)
            zero = torch.zeros((NUM_ENVS, env.num_actions), device=dev)
            with torch.no_grad():
                state, obs, _, _, _ = count(path, lambda: env.step(state, zero))
            expect_launches(path, {kernel: env.decimation})
            finite = all(bool(torch.isfinite(x).all()) for x in (state.sim.dof_pos, state.sim.root_pos,
                                                                  obs["actor_obs"]))
            log(f"{path}: physics {env.physics}, rao bump on joints {moved} (option's {joints}), "
                f"state and observations finite {finite}")
            if not (env.use_pstau and env.physics == physics and moved == joints and finite):
                log(f"FAIL: {path}")
                ok = False
            del cfg, env, state, obs, rao, zero
            torch.cuda.empty_cache()

    def serving(path, ckpt, n, jax_ratio, band, overrides=(), kernel="apgd_lanes"):
        """`episode_ratio` of `ckpt` at `n` envs, its launches counted from 0:
        4 of `kernel` (kernel 1 in one matvec mode) per control step on the
        lanes engine, none per env (`kernel` None)."""
        nonlocal ok
        with phase(path):
            res = count(path, lambda: batch_eval.episode_ratio(ckpt, n, overrides, device=dev))
            log(f"episode_ratio ({path}): " + json.dumps(res))
            expect_launches(path, {kernel: 4 * res["episode_steps"]} if kernel else {})
            if res["nonfinite_env_steps"] != 0:
                log(f"FAIL: {res['nonfinite_env_steps']} env-steps ended non-finite")
                ok = False
            if not abs(res["ratio"] - jax_ratio) <= band:
                log(f"FAIL: ratio {res['ratio']:.6f} outside {jax_ratio} +- {band}")
                ok = False
            log(f"{path}: control_steps_per_sec {res['control_steps_per_sec']:.3f} at {n} envs on {card}")
        torch.cuda.empty_cache()

    serving("serving", CKPT, NUM_ENVS, JAX_RATIO, RATIO_BAND)
    serving("serving-kb2", KB2_CKPT, KB2_ENVS, KB2_JAX_RATIO, KB2_RATIO_BAND)
    serving("serving-terrain", TERRAIN_CKPT, NUM_ENVS, TERRAIN_JAX_RATIO, TERRAIN_RATIO_BAND)
    serving("serving-apgd", CKPT, NUM_ENVS, APGD_JAX_RATIO, APGD_RATIO_BAND, PER_ENV, kernel=None)
    serving("serving-bf16", CKPT, NUM_ENVS, BF16_JAX_RATIO, BF16_RATIO_BAND, BF16, kernel="apgd_lanes_bf16")

    def train_v1(path, selections, solver, iters):
        """The training CLI on a v1 selection set at 4096 envs for `iters`
        iterations, logging every one (logging_interval 5 -> 1); returns
        (algo, ts, logs, final checkpoints)."""
        nonlocal ok
        kernel = {"lanes": "apgd_lanes", "pallas": "apgd_envfirst"}[solver]
        other = "apgd_envfirst" if kernel == "apgd_lanes" else "apgd_lanes"
        with phase(path):
            base = os.path.join(REPO, "build", "chip_smoke", path)
            shutil.rmtree(base, ignore_errors=True)
            argv = selections + TRAIN_OVERRIDES + [
                f"simulator.config.solver={solver}", f"algo.config.num_learning_iterations={iters}",
                "algo.config.logging_interval=5", f"base_dir={base}", f"artifact_dir={base}/artifacts"]
            algo, ts, logs = count(path, lambda: train.main(argv))
            expect_launches(path, {kernel: 96 * iters, other: 0})
            bad = sorted({k for it_log in logs for k, v in it_log.items() if v != v or abs(v) == float("inf")})
            if bad or len(logs) != iters:
                log(f"FAIL: {path}: {len(logs)} logged iterations, non-finite values {bad}")
                ok = False
            timed = logs[1:]           # the first iteration warms up cuBLAS and the allocator
            if timed:
                steps = algo.num_steps * algo.env.num_envs
                eps = steps * len(timed) / sum(x["rollout_s"] + x["update_s"] for x in timed)
                log(f"{path}: train_env_steps_per_sec {eps:.1f} at {algo.env.num_envs} envs on {card} "
                    f"(iterations 2-{iters})")
            log(f"{path}: per iteration rollout/update seconds "
                + ", ".join(f"{x['rollout_s']:.3f}/{x['update_s']:.3f}" for x in logs))
            log(f"{path}: last log: rew/step {logs[-1]['Train/mean_step_reward']:.4f}, "
                f"kl {logs[-1]['Loss/kl']:.4f}, lr {logs[-1]['Loss/lr']:.2e}, "
                f"value loss {logs[-1]['Loss/value']:.4f}")
            ckpts = glob.glob(os.path.join(base, "PBHC_TPU", "*", "ckpt", f"model_{iters}.pkl"))
        torch.cuda.empty_cache()
        return algo, ts, logs, ckpts

    trained = {solver: train_v1(f"train-{solver}", TRAIN_SELECTIONS, solver, TRAIN_ITERS[solver])
               for solver in ("lanes", "pallas")}

    with phase("update"):
        algo, ts, _, _ = trained["lanes"]
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
        algo, ts, _, ckpts = trained["pallas"]
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
    with phase("dp"):
        # env-axis data parallelism on bench.py's v1 training cell (4096 envs,
        # lanes): (a) one rollout of the train-lanes state on this process,
        # split by env, learned on 2 gloo ranks sharing the card against the
        # one-process update on the whole; (b) the training CLI under those 2
        # ranks (2 x 2048 envs); (c) the training CLI under a 1-rank nccl group
        # at 4096 envs. Launches counted from 0 in each rank (b, c).
        from pbhc_tpu_torch.parallel.mesh import run_ranks

        base = os.path.join(REPO, "build", "chip_smoke", "dp")
        shutil.rmtree(base, ignore_errors=True)
        os.makedirs(base)
        algo, ts, lanes_logs, _ = trained["lanes"]
        # the configured initial lr, so that the update moves the weights
        ts.lr = torch.tensor(float(algo.config.actor_learning_rate), device=dev)
        names = [f"{net}.{n}" for net in ("actor", "critic") for n, _ in getattr(ts, net).named_parameters()]
        _, obs, traj, _ = algo.rollout(ts)
        n_all, T = algo.env.num_envs, algo.num_steps
        gen = torch.Generator(device=dev).manual_seed(11)
        perms = [torch.randperm(T * n_all, generator=gen, device=dev) for _ in range(algo.num_epochs)]
        paths = {k: os.path.join(base, f"{k}.pt") for k in ("state", "perms", "half0", "half1")}
        torch.save([p.cpu() for p in perms], paths["perms"])
        torch.save({"actor": {k: v.cpu() for k, v in ts.actor.state_dict().items()},
                    "critic": {k: v.cpu() for k, v in ts.critic.state_dict().items()},
                    "actor_opt": ts.actor_opt.state_dict(), "critic_opt": ts.critic_opt.state_dict(),
                    "lr": ts.lr.cpu()}, paths["state"])
        for r in range(DP_WORLD):
            sl = slice(r * n_all // DP_WORLD, (r + 1) * n_all // DP_WORLD)
            torch.save({"obs": {"critic_obs": obs["critic_obs"][sl].cpu()},
                        "traj": {k: v[:, sl].cpu() for k, v in traj.items()}}, paths[f"half{r}"])
        params = lambda: [p.detach().cpu().numpy() for p in [*ts.actor.parameters(), *ts.critic.parameters()]]
        start = params()

        def learn_once(p):
            """The one-process update of the saved state on the rollout, permutations `p`."""
            state = torch.load(paths["state"], weights_only=False)
            ts.actor.load_state_dict(state["actor"])
            ts.critic.load_state_dict(state["critic"])
            ts.actor_opt.load_state_dict(state["actor_opt"])
            ts.critic_opt.load_state_dict(state["critic_opt"])
            ts.lr = state["lr"].to(dev)
            t0 = time.perf_counter()
            algo.learn(ts, (None, obs, traj, {}), perms=p)
            torch.cuda.synchronize()
            return params(), float(ts.lr), time.perf_counter() - t0

        one, lr_one, learn_one_s = learn_once(perms)
        # the same update with every minibatch's rows reversed (the same sums
        # in another order: the scale of rounding), and on other permutations
        # (other samples in every minibatch: the scale of a fault)
        mb = T * n_all // algo.num_minibatches
        reordered = learn_once([torch.cat([p[i * mb:(i + 1) * mb].flip(0) for i in range(algo.num_minibatches)])
                                for p in perms])[0]
        gen.manual_seed(12)
        resampled = learn_once([torch.randperm(T * n_all, generator=gen, device=dev) for _ in perms])[0]
        del obs, traj
        torch.cuda.empty_cache()

        def dp_argv(name, n):
            return TRAIN_SELECTIONS + [f"num_envs={n}", TRAIN_OVERRIDES[1], "simulator.config.solver=lanes",
                                       f"algo.config.num_learning_iterations={DP_ITERS}",
                                       "algo.config.logging_interval=5", f"base_dir={base}/{name}",
                                       f"artifact_dir={base}/{name}/artifacts"]

        learn = (TRAIN_SELECTIONS + TRAIN_OVERRIDES + ["simulator.config.solver=lanes"], paths["state"],
                 [paths["half0"], paths["half1"]], paths["perms"])
        t0 = time.perf_counter()
        ranks = run_ranks(dp_rank, DP_WORLD, (learn, dp_argv("two", NUM_ENVS)), backend="gloo", timeout=600)
        two_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (nccl,) = run_ranks(dp_rank, 1, (None, dp_argv("nccl", NUM_ENVS)), backend="nccl", timeout=600)
        nccl_s = time.perf_counter() - t0

        def parted(got):
            """(the worst tensor's |got - one| / |one - start|, its name, the max abs diff)."""
            rel = [float(np.linalg.norm(g - o) / max(np.linalg.norm(o - s0), 1e-30))
                   for g, o, s0 in zip(got, one, start)]
            i = int(np.argmax(rel))
            return rel[i], names[i], max(float(np.abs(g - o).max()) for g, o in zip(got, one))

        split = max(parted(r["learn"]["params"]) for r in ranks)
        rounding, fault = parted(reordered), parted(resampled)
        lrs = [r["learn"]["lr"] for r in ranks]
        log(f"dp (a): update on {DP_WORLD} gloo ranks x {n_all // DP_WORLD} envs vs one process on {n_all}, "
            f"worst tensor's distance over its movement {split[0]:.3e} ({split[1]}; tol {DP_RTOL:g}), max abs "
            f"diff {split[2]:.3e}; the one process against itself with rows reversed {rounding[0]:.3e} "
            f"({rounding[1]}), max abs {rounding[2]:.3e}; on other permutations {fault[0]:.3e} ({fault[1]}), "
            f"max abs {fault[2]:.3e}; lr {lrs} vs {lr_one!r}")
        if not (split[0] <= DP_RTOL and fault[0] > DP_RTOL and all(lr == lr_one for lr in lrs)):
            log("FAIL: dp: the data-parallel update disagrees with the one-process update "
                "(or the bound does not tell other samples apart)")
            ok = False
        for name, results in (("dp", [r["train"] for r in ranks]), ("dp-nccl", [nccl["train"]])):
            for n in KERNEL_NAMES:
                launches[n][name] = sum(r["launches"][n] for r in results)
            for r, res in enumerate(results):
                bad = sorted({k for x in res["logs"] for k, v in x.items() if not np.isfinite(v)})
                want = dict(dict.fromkeys(KERNEL_NAMES, 0), apgd_lanes=96 * DP_ITERS)
                log(f"{name} rank {r}/{res['world']} ({res['backend']}, {res['local_envs']} envs): launches "
                    f"{res['launches']}, per iteration rollout/update seconds "
                    + ", ".join(f"{x['rollout_s']:.3f}/{x['update_s']:.3f}" for x in res["logs"])
                    + f", replica checksums {[x.get('replica_checksum') for x in res['logs']]}")
                if bad or len(res["logs"]) != DP_ITERS or res["launches"] != want:
                    log(f"FAIL: {name} rank {r}: non-finite {bad}, {len(res['logs'])} logged iterations, "
                        f"launches {res['launches']} (want {want})")
                    ok = False
        two = [r["train"] for r in ranks]
        sums = [[x["replica_checksum"] for x in res["logs"]] for res in two]
        if sums[0] != sums[1] or not all(
                np.array_equal(a, b) for a, b in zip(_leaves(two[0]["actor"]), _leaves(two[1]["actor"]))):
            log(f"FAIL: dp: the ranks' replicated state differs: checksums {sums}")
            ok = False
        ckpts = glob.glob(os.path.join(base, "two", "PBHC_TPU", "*", "ckpt", f"model_{DP_ITERS}.pkl"))
        nets = []
        if len(ckpts) == 1:
            payload = load_checkpoint_payload(ckpts[0])
            cfg = compose(TRAIN_SELECTIONS, [f"num_envs={NUM_ENVS}"])
            nets = [flax_params(from_flax(payload["actor_params"], actor_from_config(cfg, algo.actor_dim, algo.num_act))),
                    flax_params(from_flax(payload["critic_params"],
                                          critic_from_config(cfg, algo.critic_dim, algo.num_rew)))]
        same = len(nets) == 2 and all(np.array_equal(a, b) for got, want in zip(nets, (two[0]["actor"], two[0]["critic"]))
                                      for a, b in zip(_leaves(got), _leaves(want)))
        log(f"dp (b): rank 0's checkpoints {[os.path.relpath(c, REPO) for c in ckpts]} read back through convert.py "
            f"{'identical' if same else 'DIFFERENT'} to its train state")
        if not same:
            log("FAIL: dp: rank 0's checkpoint does not load as its train state")
            ok = False
        # (d) the dryrun entry point on the card: its ranks share cuda:0 (gloo)
        from pbhc_tpu_torch.parallel.dryrun import ENVS_PER_RANK, dryrun_multichip

        t0 = time.perf_counter()
        dry_reward = dryrun_multichip(DP_WORLD, device="cuda", timeout=300)
        dry_s = time.perf_counter() - t0
        log(f"dp (d): parallel.dryrun on the card, {DP_WORLD} ranks x {ENVS_PER_RANK} envs: "
            f"reward/step {dry_reward:.4f} in {dry_s:.1f} s")
        if not np.isfinite(dry_reward):
            log("FAIL: dp: the dryrun's reward is not finite")
            ok = False
        sec = lambda x: x["rollout_s"] + x["update_s"]
        dp = {"update_seconds": {"one_process": learn_one_s, "gloo_ranks": [r["learn"]["seconds"] for r in ranks]},
              "iteration_seconds": {"single_process_4096": [sec(x) for x in lanes_logs],
                                    "gloo_2x2048": [sec(x) for x in two[0]["logs"]],
                                    "nccl_1x4096": [sec(x) for x in nccl["train"]["logs"]]},
              "call_seconds": {"gloo_2x2048": two_s, "nccl_1x4096": nccl_s, "dryrun_gloo_2x4": dry_s},
              "params_max_abs_diff": split[2],
              "relative_distance": {"split": split[0], "rows_reversed": rounding[0], "other_permutations": fault[0]},
              "card": card}
        print(json.dumps({"dp": dp}), flush=True)
        del algo, ts, ranks, nccl
    del trained
    torch.cuda.empty_cache()

    for solver in ("lanes", "pallas"):
        # every env on a random row of the curriculum grid (terrain=locomotion
        # has curriculum false), the hardest tiles included
        path = f"train-terrain-{solver}"
        algo, ts, logs, _ = train_v1(path, TERRAIN_SELECTIONS, solver, TERRAIN_ITERS)
        levels = [(x["Env/terrain_level_mean"], x["Env/terrain_level_max"]) for x in logs
                  if "Env/terrain_level_mean" in x]
        log(f"{path}: Env/terrain_level_mean/max per iteration {levels}")
        if algo.env.terrain is None or len(levels) != TERRAIN_ITERS or not levels[0][1] > 0:
            log(f"FAIL: {path}: no terrain, or its levels were not logged")
            ok = False
        del algo, ts, logs

    algo, ts, _, _ = train_v1("train-phase", TRAIN_SELECTIONS + PHASE, "lanes", 1)
    kinds = (type(ts.actor).__name__, type(ts.critic).__name__)
    log(f"train-phase: networks {kinds}, phase at {algo.phase_pos}")
    if kinds != ("PhaseAwareActor", "PhaseAwareCritic"):
        log("FAIL: train-phase did not build phase-aware networks")
        ok = False
    del algo, ts

    def train_kb2(path, role, extra):
        """The training CLI on a KungfuBot2 selection set at 2048 envs;
        returns (algo, ts, logs, run directory)."""
        nonlocal ok
        base = os.path.join(REPO, "build", "chip_smoke", path)
        shutil.rmtree(base, ignore_errors=True)
        argv = KB2_SELECTIONS[role] + [f"num_envs={KB2_ENVS}", KB2_MOTION, "algo.config.logging_interval=5",
                                       f"base_dir={base}", f"artifact_dir={base}/artifacts",
                                       f"experiment_name=kb2_{role}"] + extra
        algo, ts, logs = count(path, lambda: train.main(argv))
        bad = sorted({k for it_log in logs for k, v in it_log.items() if v != v or abs(v) == float("inf")})
        if bad:
            log(f"FAIL: {path}: non-finite logged values {bad}")
            ok = False
        if len(logs) > 1:
            timed = logs[1:]       # the first iteration warms up cuDNN, cuBLAS and the allocator
            eps = algo.num_steps * KB2_ENVS * len(timed) / sum(x["rollout_s"] + x["update_s"] for x in timed)
            log(f"{path}: train_env_steps_per_sec {eps:.1f} at {KB2_ENVS} envs on {card} (iterations 2-"
                f"{len(logs)}); per iteration rollout/update seconds "
                + ", ".join(f"{x['rollout_s']:.3f}/{x['update_s']:.3f}" for x in logs))
        runs = sorted(glob.glob(os.path.join(base, "PBHC_TPU", "*-kb2_*")))
        return algo, ts, logs, runs[-1]

    with phase("train-kb2-teacher"):
        algo, ts, logs, run = train_kb2("train-kb2-teacher", "teacher",
                                        [f"algo.config.num_learning_iterations={KB2_ITERS}"])
        expect_launches("train-kb2-teacher", {"apgd_lanes": 96 * KB2_ITERS, "apgd_envfirst": 0})
        need = {"Loss/priv_reg", "Loss/surrogate", "Loss/value", "Loss/kl", "Loss/lr"}
        if len(logs) != KB2_ITERS or not need <= set(logs[0]) or "Loss/hist_latent" not in logs[0] \
                or "Loss/hist_latent" in logs[1]:
            log(f"FAIL: train-kb2-teacher logged {[sorted(x) for x in logs]}")
            ok = False
        log(f"train-kb2-teacher: iteration 1 (RL + DAgger) priv_reg {logs[0]['Loss/priv_reg']:.4f}, "
            f"hist_latent {logs[0]['Loss/hist_latent']:.4f}; iteration 2 kl {logs[1]['Loss/kl']:.4f}, "
            f"value loss {logs[1]['Loss/value']:.4f}")
        teacher_run = (algo, ts, run)
    torch.cuda.empty_cache()

    with phase("train-kb2-student"):
        algo, ts, logs, _ = train_kb2("train-kb2-student", "student", [
            f"algo.config.num_learning_iterations={KB2_ITERS}", f"algo.config.teacher_model_path={KB2_CKPT}",
            "algo.config.dagger_only=true"])
        expect_launches("train-kb2-student", {"apgd_lanes": 96 * KB2_ITERS, "apgd_envfirst": 0})
        frozen = all(torch.equal(a, b) for a, b in zip(ts.net.actor.history_encoder.parameters(),
                                                        algo.teacher.net.actor.history_encoder.parameters()))
        log(f"train-kb2-student: Loss/bc {[round(x['Loss/bc'], 5) for x in logs]}, history encoder "
            f"{'identical to' if frozen else 'DIFFERENT from'} the teacher's after training")
        if len(logs) != KB2_ITERS or not frozen:
            log("FAIL: train-kb2-student")
            ok = False
        del algo, ts, logs
    torch.cuda.empty_cache()

    with phase("update-kb2"):
        algo, ts, _ = teacher_run
        cpu = mimic_cpu_copy(algo, ts)
        # the configured lr (the trained state's adaptive lr may sit at its
        # floor) and an iteration inside the priv-reg ramp (coefficient 0.05)
        for st, d in ((ts, dev), (cpu, "cpu")):
            st.lr, st.iteration = torch.tensor(algo.learning_rate, device=d), 2500
        batch = mimic_update_batch(torch, algo, ts, cpu, KB2_UPDATE_SAMPLES)
        m_cpu = algo.update_rl(cpu, batch)
        m_gpu = algo.update_rl(ts, {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        worst = max(float((a.detach().cpu() - c.detach()).abs().max())
                    for a, c in zip(ts.net.parameters(), cpu.net.parameters()))
        lr_same = float(ts.lr) == float(cpu.lr)
        log(f"one PPOMimic RL minibatch update of {KB2_UPDATE_SAMPLES} samples, card vs CPU: params max abs "
            f"diff {worst:.3e} (tol {UPDATE_ATOL:g}), lr {float(ts.lr):.3e} vs {float(cpu.lr):.3e}, kl "
            f"{float(m_gpu['kl']):.6f} vs {float(m_cpu['kl']):.6f}, priv_reg {float(m_gpu['priv_reg']):.6f} vs "
            f"{float(m_cpu['priv_reg']):.6f}")
        if not (worst <= UPDATE_ATOL and lr_same):
            log("FAIL: the card's PPOMimic update disagrees with the CPU's")
            ok = False
        del cpu, batch
    torch.cuda.empty_cache()

    with phase("resume"):
        _, _, run = teacher_run
        ckpt = os.path.join(run, "ckpt", f"model_{KB2_ITERS}.pkl")
        saved = load_checkpoint_payload(ckpt)
        algo, ts, logs, run3 = train_kb2("resume", "teacher", [f"checkpoint={ckpt}",
                                                               f"total_iterations={KB2_ITERS + 1}"])
        expect_launches("resume", {"apgd_lanes": 96, "apgd_envfirst": 0})
        opt_saved, hist_saved = saved[OPT_KEY]["opt"], saved[OPT_KEY]["hist_opt"]
        # iteration 2 is RL only: `opt` took 5 x 4 steps from the saved count;
        # `hist_opt` did not move, so its moments are the saved ones exactly
        hist_same = ts.hist_opt.count == hist_saved["count"] and all(
            np.array_equal(m.cpu().numpy(), s) for m, s in zip(ts.hist_opt.mu + ts.hist_opt.nu,
                                                              hist_saved["mu"] + hist_saved["nu"]))
        resumed = os.path.join(run3, "ckpt", f"model_{KB2_ITERS + 1}.pkl")
        line = f"resumed from {ckpt} at iteration {KB2_ITERS}"
        log_ok = line in open(os.path.join(run3, "train.log")).read()
        log(f"resume: ran {[x['iteration'] for x in logs]}, opt steps {opt_saved['count']} -> {ts.opt.count}, "
            f"hist_opt moments {'restored' if hist_same else 'NOT restored'}, saved lr {saved['lr']:.3e}, "
            f"wrote {os.path.relpath(resumed, REPO)}: {os.path.isfile(resumed)}")
        if not (log_ok and hist_same and [x["iteration"] for x in logs] == [KB2_ITERS + 1]
                and ts.iteration == KB2_ITERS + 1 and ts.opt.count == opt_saved["count"] + 20
                and os.path.isfile(resumed)):
            log("FAIL: the resumed run did not continue from the saved state")
            ok = False
        del teacher_run, algo, ts
    torch.cuda.empty_cache()

    with phase("train-kb2-moe"):
        algo, ts, logs, _ = train_kb2("train-kb2-moe", "teacher", ["algo.config.num_learning_iterations=1", *MOE])
        expect_launches("train-kb2-moe", {"apgd_lanes": 96, "apgd_envfirst": 0})
        lb = logs[0].get("Loss/load_balancing", float("nan")) if logs else float("nan")
        log(f"train-kb2-moe: Loss/load_balancing {lb:.5f}, Loss/hist_latent {logs[0].get('Loss/hist_latent')}, "
            f"backbones {type(ts.net.actor.backbone).__name__}/{type(ts.net.critic).__name__}; per iteration "
            "rollout/update seconds " + ", ".join(f"{x['rollout_s']:.3f}/{x['update_s']:.3f}" for x in logs))
        if not (len(logs) == 1 and lb > 0 and "Loss/hist_latent" in logs[0]
                and type(ts.net.critic).__name__ == "MoEMLP"):
            log("FAIL: train-kb2-moe: no positive load-balance loss, or not RL + DAgger with MoE nets")
            ok = False
        moe_run = (algo, ts)
    torch.cuda.empty_cache()

    with phase("update-kb2-moe"):
        algo, ts = moe_run
        cpu = mimic_cpu_copy(algo, ts)
        for st, d in ((ts, dev), (cpu, "cpu")):
            st.lr, st.iteration = torch.tensor(algo.learning_rate, device=d), 2500
        batch = mimic_update_batch(torch, algo, ts, cpu, KB2_UPDATE_SAMPLES)
        m_cpu = algo.update_rl(cpu, batch)
        m_gpu = algo.update_rl(ts, {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        worst = max(float((a.detach().cpu() - c.detach()).abs().max())
                    for a, c in zip(ts.net.parameters(), cpu.net.parameters()))
        lr_same = float(ts.lr) == float(cpu.lr)
        log(f"one PPOMimic RL minibatch update with MoE nets, {KB2_UPDATE_SAMPLES} samples, card vs CPU: params "
            f"max abs diff {worst:.3e} (tol {UPDATE_ATOL:g}), lr {float(ts.lr):.3e} vs {float(cpu.lr):.3e}, "
            f"load_balancing {float(m_gpu['load_balancing']):.6f} vs {float(m_cpu['load_balancing']):.6f}")
        if not (worst <= UPDATE_ATOL and lr_same):
            log("FAIL: the card's MoE PPOMimic update disagrees with the CPU's")
            ok = False
        del moe_run, algo, ts, cpu, batch
    torch.cuda.empty_cache()

    with phase("eval-agent"):
        base = os.path.join(REPO, "build", "chip_smoke", "eval-agent")
        shutil.rmtree(base, ignore_errors=True)
        run = os.path.join(base, "card", EVAL_RUN)
        shutil.copytree(os.path.join(REPO, "artifacts", EVAL_RUN), run)
        ckpt = os.path.join(run, "ckpt", "model_10500.pkl")
        res = count("eval-agent", lambda: eval_agent.main([f"checkpoint={ckpt}", *EVAL_OFF, "save_motion=true"]))
        # the CPU's export of the same checkpoint, as the CLI writes it
        env, actor, cfg = batch_eval.load(ckpt, 1, EVAL_OFF, device="cpu")
        cpu_npz = export_policy(actor, load_checkpoint_payload(ckpt)["actor_params"], env,
                                os.path.join(base, "cpu", "model_10500.npz"),
                                meta_extra={"motion_file": str(cfg.robot.motion.motion_file)})
        same = {suffix: open(os.path.join(run, "exported", "model_10500" + suffix), "rb").read()
                == open(str(cpu_npz.with_suffix(suffix)), "rb").read() for suffix in (".npz", ".onnx")}
        steps = round(res["completion_ratio"] * eval_agent.clip_steps(env))
        expect_launches("eval-agent", {"apgd_lanes": 4 * steps, "apgd_envfirst": 0})
        fams = {**res["accuracy"], **res["smoothness"]}
        log(f"eval-agent: completion_ratio {res['completion_ratio']} over {steps} steps (JAX {EVAL_JAX_COMPLETION}), "
            + ", ".join(f"{k} {fams[k]:.5f} (JAX {v:.5f})" for k, v in EVAL_JAX_FAMILIES.items())
            + f"; exports identical to the CPU's: {same}; families " + json.dumps(fams))
        if not all(same.values()):
            log("FAIL: eval-agent: the card's export differs from the CPU's")
            ok = False
        if res["completion_ratio"] != EVAL_JAX_COMPLETION or not all(np.isfinite(v) for v in fams.values()):
            log("FAIL: eval-agent: completion ratio or non-finite families")
            ok = False
        for k, v in EVAL_JAX_FAMILIES.items():
            if not abs(fams[k] - v) <= EVAL_REL_BAND * v:
                log(f"FAIL: eval-agent: {k} {fams[k]:.5f} outside {v} +- {EVAL_REL_BAND:.0%}")
                ok = False
        # save_motion=true: the rollout as a motion clip, read back by the
        # port's joblib reader in the JAX package's schema (`pbhc_tpu/eval_agent.py:215-227`)
        from pbhc_tpu_torch.motion.motion_lib import load_joblib

        motion = load_joblib(os.path.join(run, "motion_model_10500.pkl"))
        f32, nd = np.dtype(np.float32), 23
        schema = {"root_trans_offset": ((steps, 3), f32), "root_rot": ((steps, 4), f32), "dof": ((steps, nd), f32),
                  "pose_aa": ((steps, 1 + nd + env.num_extend, 3), f32), "fps": int,
                  "contact_mask": ((steps, 2), np.dtype(np.float64)), "dof_vel": ((steps, nd), f32),
                  "root_lin_vel": ((steps, 3), f32), "root_ang_vel": ((steps, 3), f32), "action": ((steps, nd), f32)}
        clip = motion.get("rollout", {})
        got = {k: type(v) if not isinstance(v, np.ndarray) else (v.shape, v.dtype) for k, v in clip.items()}
        log(f"eval-agent: save_motion clip keys {list(motion)} / {list(got)}, fps {clip.get('fps')}")
        if list(motion) != ["rollout"] or got != schema or list(clip) != list(schema) or clip["fps"] != 50 \
                or not all(np.isfinite(v).all() for v in clip.values() if isinstance(v, np.ndarray)):
            log(f"FAIL: eval-agent: save_motion wrote {got}, want {schema}")
            ok = False
        del env, actor
    torch.cuda.empty_cache()

    with phase("deploy"):
        import hashlib

        from pbhc_tpu_torch.deploy import export
        from pbhc_tpu_torch.deploy.native import NativePolicy
        from pbhc_tpu_torch.deploy.native.onnx_exec import NativeOnnxPolicy
        from pbhc_tpu_torch.deploy.onnx_numpy import OnnxPolicy
        from pbhc_tpu_torch.deploy.teleop import TeleopSource

        t_deploy = time.perf_counter()
        base = os.path.join(REPO, "build", "chip_smoke", "deploy")
        shutil.rmtree(base, ignore_errors=True)
        # 1. the export CLI on the card, and on the CPU in this process
        onnx = export.main(["student", STUDENT_CKPT, os.path.join(base, "student.onnx")])
        cpu_onnx = export.main(["student", STUDENT_CKPT, os.path.join(base, "cpu", "student.onnx"), "device=cpu"])
        data = onnx.read_bytes()
        meta = json.loads(open(str(onnx) + ".meta.json").read())
        same_cpu = data == cpu_onnx.read_bytes() and meta == json.loads(open(str(cpu_onnx) + ".meta.json").read())
        sha = hashlib.sha256(data).hexdigest()
        log(f"deploy: student export {len(data)} bytes, sha256 {sha} (JAX {STUDENT_ONNX_SHA256}); "
            f"ONNX and meta equal to the CPU's: {same_cpu}")
        if not same_cpu or sha != STUDENT_ONNX_SHA256:
            log("FAIL: deploy: the card's student export differs from the CPU's or from the JAX package's")
            ok = False
        # 2. the student's deploy chain at its own 2048 envs
        env, net, _ = batch_eval.load(STUDENT_CKPT, KB2_ENVS, STUDENT_OFF, device=dev)
        chain = count("deploy", lambda: student_deploy_chain(torch, env, net, onnx, DEPLOY_STEPS))
        expect_launches("deploy", {"apgd_lanes": 4 * DEPLOY_STEPS, "apgd_envfirst": 0})
        log(f"deploy: student chain over {DEPLOY_STEPS} steps at {KB2_ENVS} envs: " + json.dumps(chain))
        obs_worst = max(v for k, v in chain.items() if k.startswith("obs_"))
        exec_worst = max(v for k, v in chain.items() if k.startswith("exec_"))
        if chain["compared"] < DEPLOY_MIN_COMPARED:
            log(f"FAIL: deploy: only {chain['compared']} steps compared (want >= {DEPLOY_MIN_COMPARED})")
            ok = False
        if not obs_worst <= DEPLOY_OBS_ATOL:
            log(f"FAIL: deploy: deploy inputs {obs_worst:.3e} from the env's (tol {DEPLOY_OBS_ATOL:g})")
            ok = False
        if not exec_worst <= DEPLOY_ACT_ATOL:
            log(f"FAIL: deploy: a host executor {exec_worst:.3e} from the card's student (tol {DEPLOY_ACT_ATOL:g})")
            ok = False
        student_feeds = {k: np.zeros((1, int(v)), np.float32) for k, v in
                         (("actor_obs", meta["obs_dim"]), *((k, env.obs_dim(k)) for k in
                                                            ("future_motion_targets", "prop_history")))}
        del env, net
        torch.cuda.empty_cache()
        # 3. the side-kick's exports (eval-agent's) on the host executors, on
        #    the observations of 64 envs of one serving step
        exported = os.path.join(REPO, "build", "chip_smoke", "eval-agent", "card", EVAL_RUN, "exported")
        npz, sk_onnx = os.path.join(exported, "model_10500.npz"), os.path.join(exported, "model_10500.onnx")
        env, actor, _ = batch_eval.load(CKPT, 64, device=dev)
        state, obs = batch_eval.start_episodes(env)
        with torch.no_grad():
            state, obs, _, _, _ = env.step(state, actor(obs["actor_obs"])[0])
            mean = actor(obs["actor_obs"])[0].cpu().numpy()
        sk_obs = obs["actor_obs"].cpu().numpy()
        side_kick = {"NativePolicy": float(np.abs(NativePolicy(npz)(sk_obs) - mean).max()),
                     "OnnxPolicy": float(np.abs(OnnxPolicy(sk_onnx)(sk_obs) - mean).max())}
        log(f"deploy: side-kick host executors against its actor on the card, 64 envs: {side_kick}")
        if not max(side_kick.values()) <= DEPLOY_ACT_ATOL:
            log("FAIL: deploy: a side-kick host executor disagrees with the card's actor")
            ok = False
        del env, actor, state, obs
        # 4. the teleop hook at 4096 envs: two control steps, one marker set over UDP
        env, actor, _ = batch_eval.load(CKPT, NUM_ENVS, TELEOP, device=dev)
        try:
            state, obs = batch_eval.start_episodes(env)
            state, _, nonfinite = batch_eval.rollout_ratio(env, actor, state, obs, 2)
            coords = np.arange(9, dtype=np.float64).reshape(3, 3) / 10
            TeleopSource.send(coords, port=env.teleop_source.addr[1])
            t0 = time.perf_counter()
            while not np.array_equal(env.teleop_source.coords, coords) and time.perf_counter() - t0 < 1.0:
                time.sleep(0.005)
            waited = time.perf_counter() - t0
            received = bool(np.array_equal(env.teleop_source.coords, coords))
            finite = bool(torch.isfinite(state.sim.dof_pos).all()) and int(nonfinite) == 0
        finally:
            env.close()
        log(f"deploy: teleop at {NUM_ENVS} envs: marker buffer {env.teleop_marker_coords.shape}, datagram "
            f"received {received} in {waited:.4f} s, state finite {finite}")
        if not (received and finite and env.teleop_marker_coords.shape == (NUM_ENVS, 3, 3)):
            log("FAIL: deploy: the teleop listener missed the marker set, or the state is not finite")
            ok = False
        del env, actor, state
        torch.cuda.empty_cache()
        # 5. the host cores' tick at batch 1 (the robot's control tick)
        sk_row = sk_obs[0]
        ticks = {"NativePolicy side-kick .npz": host_tick_us(lambda p=NativePolicy(npz): p(sk_row)),
                 "NativeOnnxPolicy student": host_tick_us(lambda p=NativeOnnxPolicy(onnx, meta): p.run(student_feeds)),
                 "OnnxPolicy student": host_tick_us(lambda p=OnnxPolicy(onnx, meta): p.run(student_feeds)),
                 "NativeOnnxPolicy side-kick": host_tick_us(lambda p=NativeOnnxPolicy(sk_onnx): p(sk_row)),
                 "OnnxPolicy side-kick": host_tick_us(lambda p=OnnxPolicy(sk_onnx): p(sk_row))}
        deploy = {"student_steps_compared": chain["compared"], "env0_done_at": chain["env0_done_at"],
                  "max_obs_err": obs_worst, "max_exec_err": exec_worst,
                  "max_chain_err": max(chain["chain_numpy"], chain["chain_native"]),
                  "errors": {k: v for k, v in chain.items() if k not in ("compared", "env0_done_at")},
                  "side_kick_exec_err": side_kick, "apgd_lanes_launches": launches["apgd_lanes"]["deploy"],
                  "apgd_envfirst_launches": launches["apgd_envfirst"]["deploy"],
                  "host_tick_median_us": ticks, "teleop_received": received, "teleop_wait_s": waited,
                  "export_sha256": sha, "seconds": time.perf_counter() - t_deploy, "card": card}
        print(json.dumps({"deploy": deploy}), flush=True)

    with phase("suite"):
        # the benchmark suite's configs 2-5 through its entry point, each at its
        # own width; each prints its JSON line. Config 1 (MuJoCo) is host-only.
        from pbhc_tpu_torch.eval import benchmarks

        suite = {}
        for key in ("2", "3", "4", "5"):
            path = f"suite-{key}"
            (res,) = count(path, lambda: benchmarks.main([key], device=dev))
            d = res["detail"]
            expect_launches(path, {"apgd_lanes": 4 * (d["warmup_steps"] + d["steps"]), "apgd_envfirst": 0})
            if not (res["value"] > 0 and np.isfinite(res["value"]) and np.isfinite(d["reward_sums"]).all()):
                log(f"FAIL: {path}: value {res['value']}, reward sums {d['reward_sums']}")
                ok = False
            if key == "4" and not d["library_clips"] == d["num_unique"] == 3:
                log(f"FAIL: {path}: merged library read back with {d['library_clips']} clips, "
                    f"env num_unique {d['num_unique']} (want 3)")
                ok = False
            log(f"{path}: {res['config']} {d['steps'] * d['num_envs'] / d['seconds']:.3f} env-steps/s at "
                f"{d['num_envs']} envs on {card}: " + json.dumps(d))
            suite[res["config"]] = dict(env_steps_per_sec=d["steps"] * d["num_envs"] / d["seconds"], **d)
            del res
            torch.cuda.empty_cache()
        print(json.dumps({"suite": suite, "card": card}), flush=True)

    with phase("motion"):
        # the offline motion pipeline on the card: the retarget fit of 200
        # frames at 600 iterations (the committed clip's joints and synthetic
        # ones) against the JAX package's figures, the fit on the card against
        # the CPU, the motion tools' FK, and the smpl_npz CLI end to end
        import subprocess

        from pbhc_tpu_torch.model.g1 import load_g1_motion_model, load_g1_sim_model
        from pbhc_tpu_torch.model.kinematics import fk_pose_aa
        from pbhc_tpu_torch.motion import filter as motion_filter
        from pbhc_tpu_torch.motion import tools as motion_tools
        from pbhc_tpu_torch.motion.motion_lib import MotionLib, load_joblib
        from pbhc_tpu_torch.motion.retarget import retarget_smpl_joints

        base = os.path.join(REPO, "build", "chip_smoke", "motion")
        shutil.rmtree(base, ignore_errors=True)
        os.makedirs(base)
        model, sim_model = load_g1_motion_model(), load_g1_sim_model()
        secs, errs = {}, {}

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            return out

        clip_joints = next(iter(load_joblib("assets/motions/Horse-stance_punch.pkl").values()))["smpl_joints"]
        synth = synthetic_smpl_joints(200)
        for name, joints, want in (("clip", clip_joints, RETARGET_JAX_ERR_CLIP),
                                   ("synthetic", synth, RETARGET_JAX_ERR_SYNTH)):
            fit = timed(f"retarget_{name}", lambda: retarget_smpl_joints(model, joints, iters=600, device=dev))
            errs[name] = fit["retarget_mean_error_m"]
            log(f"motion: retarget of {len(joints)} frames ({name}) at 600 iterations: retarget_mean_error_m "
                f"{errs[name]!r} (JAX {want!r}) in {secs[f'retarget_{name}']:.3f} s on {card}")
            if not (errs[name] < RETARGET_MAX_ERR and abs(errs[name] - want) <= RETARGET_ERR_BAND
                    and all(np.isfinite(v).all() for v in fit.values() if isinstance(v, np.ndarray))):
                log(f"FAIL: motion: retarget ({name}) error {errs[name]} not below {RETARGET_MAX_ERR} and within "
                    f"{RETARGET_ERR_BAND} of {want}")
                ok = False
        card_fit = timed("retarget_50_card", lambda: retarget_smpl_joints(model, synth, iters=50, device=dev))
        cpu_fit = timed("retarget_50_cpu", lambda: retarget_smpl_joints(model, synth, iters=50, device="cpu"))
        fit_diff = {k: float(np.abs(card_fit[k] - cpu_fit[k]).max())
                    for k in ("root_trans_offset", "root_rot", "dof", "pose_aa")}
        log(f"motion: 50 fit iterations, card vs CPU: max abs diff {fit_diff} (tol {RETARGET_CARD_CPU_ATOL:g})")
        if max(fit_diff.values()) > RETARGET_CARD_CPU_ATOL:
            log("FAIL: motion: the card's retarget fit disagrees with the CPU's")
            ok = False

        horse = next(iter(load_joblib("assets/motions/Horse-stance_pose.pkl").values()))
        f32 = lambda x, d: torch.as_tensor(np.asarray(x, dtype=np.float32), device=d)
        with torch.no_grad():
            fk = {d: fk_pose_aa(model, f32(horse["pose_aa"], d), f32(horse["root_trans_offset"], d))[0].cpu().numpy()
                  for d in (dev, "cpu")}
        masks = {d: timed(f"contact_mask_{d}", lambda: motion_tools.compute_contact_mask(horse, device=d))["contact_mask"]
                 for d in (dev, "cpu")}
        stab = {d: timed(f"stability_{d}", lambda: motion_filter.stability_score(
            model, sim_model, horse["pose_aa"], horse["root_trans_offset"], horse["fps"], device=d)) for d in (dev, "cpu")}
        fk_diff = float(np.abs(fk[dev] - fk["cpu"]).max())
        com_diff = float(np.abs(stab[dev]["com_support_dist"] - stab["cpu"]["com_support_dist"]).max())
        log(f"motion: FK of {len(fk['cpu'])} frames card vs CPU {fk_diff:.3e}, contact masks equal "
            f"{np.array_equal(masks[dev], masks['cpu'])}, CoM support distance {com_diff:.3e}")
        if not (fk_diff <= MOTION_FK_ATOL and com_diff <= MOTION_FK_ATOL and np.array_equal(masks[dev], masks["cpu"])
                and stab[dev]["grounded_frames"] == stab["cpu"]["grounded_frames"]):
            log("FAIL: motion: the motion tools on the card disagree with the CPU")
            ok = False

        npz, pkl = os.path.join(base, "smpl.npz"), os.path.join(base, "walk.pkl")
        write_smpl_npz(npz, 30)
        cli = timed("smpl_npz_cli", lambda: subprocess.run(
            [sys.executable, "-m", "pbhc_tpu_torch.motion.smpl_npz", npz, pkl, "--name", "walk"], cwd=REPO,
            capture_output=True, text=True, timeout=300))
        walk = load_joblib(pkl)["walk"] if cli.returncode == 0 else {}
        frames = int(MotionLib(pkl, model, 1, 0.02, device=dev).data.num_frames[0]) if walk else 0
        errs["smpl_npz"] = walk.get("retarget_mean_error_m", float("nan"))
        log(f"motion: smpl_npz CLI rc {cli.returncode}: {cli.stdout.strip().splitlines()[-1:]} "
            f"retarget_mean_error_m {errs['smpl_npz']!r} (JAX {SMPL_NPZ_JAX_ERR!r}); MotionLib frames {frames}")
        if cli.returncode != 0 or frames != 30 or not abs(errs["smpl_npz"] - SMPL_NPZ_JAX_ERR) <= RETARGET_ERR_BAND:
            log(f"FAIL: motion: smpl_npz CLI: {cli.stderr[-2000:]}")
            ok = False
        print(json.dumps({"motion": {"seconds": secs, "retarget_mean_error_m": errs, "card_vs_cpu_50": fit_diff,
                                     "fk_card_vs_cpu": fk_diff, "card": card}}), flush=True)

    if not ok:
        log("chip_smoke: FAILED")
        return 1
    with phase("report"):
        # kernel 1's reduced matvec modes compute what JAX's XLA `_apgd` does
        # in that dtype (engine_lanes.py:662-672), as an option of kernel 1
        sources = {name: ("pbhc_tpu_torch/csrc/apgd_lanes.cu", "pbhc_tpu/sim/pallas_contact.py:112")
                   for name in LANES_NAMES.values()}
        sources["apgd_envfirst"] = ("pbhc_tpu_torch/csrc/apgd_envfirst.cu", "pbhc_tpu/sim/pallas_contact.py:37")
        kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                        mode=kernel_bench.KERNELS[name].mode,
                        launches=sum(launches[name].values()),
                        launches_by_path=dict(launches[name]),
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
