"""The port runs where only torch, numpy, scipy and the standard library are.

The machine with the card has no JAX, PyYAML, joblib, lxml or MuJoCo. A
subprocess that blocks those modules (and `pbhc_tpu`) imports every module of
`pbhc_tpu_torch` and `chip_smoke`, builds the side-kick env and actor on the
CPU at 128 envs from the config snapshot and the checkpoint, and drives a few
control steps of the serving loop.
"""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "pbhc_tpu", "yaml", "joblib", "lxml", "mujoco")

SCRIPT = textwrap.dedent("""
    import sys
    BLOCKED = {blocked!r}
    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    for name in BLOCKED:
        sys.modules[name] = None          # any import of it raises ImportError
    sys.path.insert(0, {repo!r})

    import importlib, pkgutil
    import torch
    torch.set_num_threads(2)
    import pbhc_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(pbhc_tpu_torch.__path__, "pbhc_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke                     # import only: main() is not run

    from pbhc_tpu_torch.eval import batch_eval
    env, actor, cfg = batch_eval.load("artifacts/kb1_side_kick/ckpt/model_10500.pkl", 128, device="cpu")
    state, obs = batch_eval.start_episodes(env)
    state, first, nonfinite = batch_eval.rollout_ratio(env, actor, state, obs, 3)
    assert obs["actor_obs"].shape == (128, 380), obs["actor_obs"].shape
    assert int(state.episode_length.min()) == 3 and int(nonfinite) == 0
    assert torch.isfinite(state.sim.dof_pos).all() and torch.isfinite(state.sim.root_pos).all()
    leaked = [n for n, m in sys.modules.items() if n.split(".")[0] in BLOCKED and m is not None]
    assert not leaked, leaked
    print("modules", len(names), "ISOLATION OK")
""")


def test_port_runs_without_jax_yaml_joblib_lxml():
    script = SCRIPT.format(blocked=BLOCKED, repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ISOLATION OK" in out.stdout


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_forbidden_import_in_sources():
    files = sorted((REPO / "pbhc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        bad = _imported_roots(f) & set(BLOCKED)
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"
