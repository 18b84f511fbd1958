"""Builds `kb2-library-g1-29dof.pkl`, the motion library of the KungfuBot2
teacher's cell, from the clips committed under `assets/motions/`:

- the 29-DoF clip as it is;
- the ten 23-DoF clips, each up-converted to the 29-DoF order with zero
  wrist dofs (`pbhc_tpu_torch/motion/tools.py::convert_23dof_to_29dof`);
- all eleven merged in that order (`motion/package.py::merge`, a clip whose
  key is taken already renamed `<file stem>__<key>`) and written by the
  port's `dump`.

    python3 portbench/data/build_kb2_library.py [<out.pkl>]

The file is committed, so a run's set-up does not pay for the conversion.
"""
from __future__ import annotations

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = Path(__file__).with_name("kb2-library-g1-29dof.pkl")
MOTIONS = ROOT / "assets" / "motions"
CLIP_29 = "g1_rig_Skeleton_Sequence_converted_processed_g1_29dof_rev_1_0.pkl"


def sources() -> tuple:
    """(the 29-DoF clip's file, the 23-DoF clips' files in sorted order)."""
    others = sorted(p for p in MOTIONS.glob("*.pkl") if p.name != CLIP_29)
    return MOTIONS / CLIP_29, others


def build(out_path, work_dir) -> Path:
    """The library written to `out_path`; the converted clips pass through
    files under `work_dir`."""
    from pbhc_tpu_torch.motion.motion_lib import load_joblib
    from pbhc_tpu_torch.motion.package import dump, merge
    from pbhc_tpu_torch.motion.tools import convert_23dof_to_29dof

    clip_29, others = sources()
    paths = [clip_29]
    for p in others:
        clips = {k: convert_23dof_to_29dof(v) for k, v in load_joblib(p).items()}
        paths.append(Path(work_dir) / p.name)
        dump(clips, paths[-1])
    return Path(merge(out_path, paths))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    sys.path.insert(0, str(ROOT))
    with tempfile.TemporaryDirectory() as work:
        print(build(Path(argv[0]) if argv else OUT, work))


if __name__ == "__main__":
    main()
