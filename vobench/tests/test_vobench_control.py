"""The control comes out not correct: the reference computed with TF32 on
(the nearest precision below the configuration's float32 with TF32 off),
put in the program's place, against the reference. On the card only, at
the cell's widths with short clips; ``python -m pytest -m cuda
vobench/tests`` there."""

import io
import json

import pytest

from vobench import bank as bank_mod, calibrate, spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["stereo.batch11", "fivept.batch11",
                                  "stereo.live"])
def test_control_is_not_correct(card, cell):
    real = spec.load_cell(cell)
    traffic = dict(real.traffic, clip_frames=41, offset_max=8,
                   clips=min(real.traffic["clips"], 2))
    small = real._replace(traffic=traffic)
    bank = bank_mod.render(50, bank_mod.HEIGHT, bank_mod.WIDTH)
    out = io.StringIO()
    calibrate.readings(small, [2 ** 31 + 5, 2 ** 31 + 6, 2 ** 31 + 7], 3,
                       device=card, bank=bank, out=out)
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    for r in rows:
        over = [k for k, lim in real.limits.items() if r[k] > lim]
        assert bool(over) == (r["kind"] == "control"), r
