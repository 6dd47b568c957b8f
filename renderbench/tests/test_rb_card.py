"""On a CUDA card only: one short run of each cell, as the driver makes
it, comes out correct.  Skipped without a card.

    python -m pytest renderbench/tests -q -m card
"""

import json

import pytest

from renderbench import manifest, run

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell, card, capsys):
    assert run.main(["--workload", cell, "--seed", str(2**31 + 5),
                     "--seconds", "2", "--trace", "0"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("config", ["heightfield_hdri_65k",
                                    "config5_textured_1m"])
def test_the_reference_replays_its_stages_bit_for_bit(config, card):
    import numpy as np
    import torch

    from renderbench import scene
    from renderbench.reference import render

    bench = manifest.load()
    entry = {c["name"]: c for c in bench["configs"]}[config]
    with open(f"{manifest.ROOT}/{entry['file']}") as f:
        raw = scene.make(json.load(f), 2**31 + 9)
    ref = render.prepare(raw, card)
    pix = torch.tensor(np.sort(np.random.default_rng(1).choice(
        raw["x_res"] * raw["y_res"], 1024, replace=False)), device=card)
    graphed = render.render_pixels(ref, pix, 6)
    passes = torch.zeros_like(graphed[0])
    samples = torch.zeros_like(graphed[1])
    rng = render.init_rng(pix)
    with torch.no_grad():
        for _ in range(6):
            light, ok, aov, rng, _ = render.sample_radiance(ref, rng, pix)
            passes, samples = render.accumulate(passes, samples, light, ok,
                                                aov)
    assert torch.equal(graphed[0], passes)
    assert torch.equal(graphed[1], samples)
