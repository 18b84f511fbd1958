"""Each cell's files are found by name, and a new cell, configuration,
traffic mix and per-layer metric are picked up from new files and
`BENCHMARK.json` entries alone."""
import json
import shutil
from pathlib import Path

import pytest
from conftest import tiny

from portbench.harness import Cell, load_json, run_cell

ROOT = Path(__file__).resolve().parents[2]
SPEC = load_json(ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_file_of_a_cell_is_found(cell):
    c = Cell(cell)
    bench = ROOT / "portbench"
    assert (bench / "configs" / f"{c.spec['config']}.json").is_file()
    assert (bench / "traffic" / f"{c.spec['traffic']}.json").is_file()
    assert (bench / "loops" / f"{c.traffic['loop']}.py").is_file()
    loop = c.loop()
    assert loop.Loop and loop.numbers and loop.FAULTS
    assert set(c.limits) and set(c.references("cpu"))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]))


def test_benchmark_json_shape():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert names == {"train_env_steps_per_s", "rollout_env_steps_per_s", "control_step_ms_p95", "setup_s"}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in names and set(m["workloads"]) <= cells
    for c in SPEC["configs"]:
        assert load_json(ROOT / c["file"])["reduced"] == c["reduced"]
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


def _copy(tmp_path):
    """A checkout in `tmp_path`: the benchmark copied, the program and its
    run artifacts linked."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("pbhc_tpu_torch", "artifacts", "assets"):
        (tmp_path / name).symlink_to(ROOT / name)
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_new_files_add_a_cell_config_mix_and_metric(tmp_path):
    spec = _copy(tmp_path)
    bench = tmp_path / "portbench"
    config = load_json(bench / "configs" / "kb1-sidekick-g1-23dof.json")
    config["name"] = "kb1-sidekick-small"
    config["num_envs"] = 8
    (bench / "configs" / "kb1-sidekick-small.json").write_text(json.dumps(config))
    mix = load_json(bench / "traffic" / "serve.json")
    mix["check_steps"] = 2
    (bench / "traffic" / "serve-few.json").write_text(json.dumps(mix))
    (bench / "limits" / "kb1-small-serve.json").write_text(
        (bench / "limits" / "kb1-serve.json").read_text())
    (bench / "metrics" / "env_step_ms_max.serve.py").write_text(
        "def read(ctx):\n    s = ctx['spans'].get('env.step')\n    return 1e3 * max(s) if s else None\n")
    spec["configs"].append({"name": "kb1-sidekick-small", "source": "https://arxiv.org/abs/2506.12851",
                            "file": "portbench/configs/kb1-sidekick-small.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "kb1-small-serve", "config": "kb1-sidekick-small",
                              "traffic": "serve-few", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "env_step_ms_max.serve", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "env step", "moves": "rollout_env_steps_per_s",
                              "workloads": ["kb1-small-serve"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "kb1-serve" in m["workloads"]:
            m["workloads"].append("kb1-small-serve")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = Cell("kb1-small-serve", root=tmp_path)
    assert cell.config["num_envs"] == 8 and cell.traffic["check_steps"] == 2
    assert "env_step_ms_max.serve" in {m["name"] for m in cell.per_layer}
    out = run_cell(cell, 9, 0.3, True, "cpu", overrides=tiny(cell, envs=8))
    assert out["correct"] and out["metrics"]["env_step_ms_max.serve"]["value"] > 0
    # the cells that were there are untouched by the new one
    assert Cell("kb1-serve", root=tmp_path).config["num_envs"] == 4096


LOOP = '''"""Two control steps of the deterministic actor to a unit."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("serve_base", Path(__file__).with_name("serve.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)


class Loop(base.Loop):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.env_steps_per_unit *= 2

    def unit(self, i, rng, spans):
        super().unit(i, rng, spans)
        self.step(spans)


numbers = base.numbers
FAULTS = {"state_unchanged": base.FAULTS["state_unchanged"]}
'''


def test_new_files_add_a_loop_kind(tmp_path):
    spec = _copy(tmp_path)
    bench = tmp_path / "portbench"
    (bench / "loops" / "serve_pairs.py").write_text(LOOP)
    mix = load_json(bench / "traffic" / "serve.json")
    mix["loop"] = "serve_pairs"
    (bench / "traffic" / "serve-pairs.json").write_text(json.dumps(mix))
    (bench / "limits" / "kb1-serve-pairs.json").write_text((bench / "limits" / "kb1-serve.json").read_text())
    spec["workloads"].append({"name": "kb1-serve-pairs", "config": "kb1-sidekick-g1-23dof",
                              "traffic": "serve-pairs", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "kb1-serve" in m["workloads"]:
            m["workloads"].append("kb1-serve-pairs")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = Cell("kb1-serve-pairs", root=tmp_path)
    out = run_cell(cell, 11, 0.3, False, "cpu", overrides=tiny(cell, envs=8))
    assert out["correct"], out["checks"]
    assert out["metrics"]["rollout_env_steps_per_s"]["value"] > 0
    cell = Cell("kb1-serve-pairs", root=tmp_path)
    plant = cell.loop().FAULTS["state_unchanged"]
    assert not run_cell(cell, 11, 0.3, False, "cpu", overrides=tiny(cell, envs=8), plant=plant)["correct"]
