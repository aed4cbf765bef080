"""Port parity: ICF's grouped output at default params and type-B
multiscale detection (ccv_tpu_torch/detectors/icf.py) against ccv_tpu on
the CPU, with the seeded synthetic cascades and the CPU forms of
tests/test_torch_icf.py (which holds the staged windows).

Grouped output: the same rects in the same order with the same neighbour
counts, confidences within 2e-4. Multiscale: every window under the same
gate as the staged windows, then the merged rects equal.
"""

import dataclasses

import numpy as np
import torch

from ccv_tpu.detectors import icf as jicf
from ccv_tpu_torch.detectors import icf
from test_torch_icf import (  # noqa: F401 - the fixtures are used by name
    ATOL, INTERVAL, _ccv_tpu_staged_cpu_form, assert_windows_agree, crop,
    graded, synth_cascade)


def test_grouped_default_params(graded):
    """Default IcfParams (interval 8, min_neighbors 2): grouping and the
    inclusion filters give ccv_tpu's rects in its order."""
    casc, _sums, img = graded["colour"]
    casc = dataclasses.replace(casc, thresholds=casc.thresholds - 0.5)
    want = jicf.detect_objects(img, casc)
    got = icf.detect_objects(torch.from_numpy(img),
                             icf.cascade_from_jax(casc))
    assert len(want) > 0
    assert [(c.x, c.y, c.width, c.height, c.neighbors) for c in got] == \
        [(c.x, c.y, c.width, c.height, c.neighbors) for c in want]
    for a, b in zip(got, want):
        assert abs(a.confidence - b.confidence) <= ATOL


def test_detect_multiscale(crop, tmp_path):
    """Type-B cascades: two per-scale synthetic cascades, written and read
    back as a multiscale directory, every window, then merged."""
    rng = np.random.default_rng(6)
    cs = [synth_cascade(rng, 60, False, w=24, h=48, margin=(0, 0, 0, 0)),
          synth_cascade(rng, 60, False, w=32, h=64, margin=(0, 0, 0, 0))]
    for c in cs:  # the last tree keeps ~3% of the windows
        open_ = icf.detect_multiscale(
            torch.from_numpy(crop), icf.IcfMultiscaleCascade(
                1, 0, [icf.cascade_from_jax(c)]),
            icf.IcfParams(min_neighbors=0))
        confs = np.sort([o.confidence for o in open_])
        i = int(0.97 * len(confs))
        c.thresholds[-1] = (confs[i] + confs[i + 1]) / 2
    jms = jicf.IcfMultiscaleCascade(octave=1, grayscale=0, cascades=cs)
    icf.write_multiscale_cascade(icf.IcfMultiscaleCascade(
        1, 0, [icf.cascade_from_jax(c) for c in cs]), str(tmp_path / "ms"))
    ms = icf.load_multiscale_cascade(str(tmp_path / "ms"))
    assert ms.count == 2 and ms.octave == 1
    for mn in (0, 1):
        p = dict(min_neighbors=mn, interval=INTERVAL)
        want = jicf.detect_multiscale(crop, jms, jicf.IcfParams(**p))
        got = icf.detect_multiscale(torch.from_numpy(crop), ms,
                                    icf.IcfParams(**p))
        assert len(want) > 0
        if mn == 0:
            assert_windows_agree(got, want, set())
        else:
            assert [(c.x, c.y, c.width, c.height) for c in got] == \
                [(c.x, c.y, c.width, c.height) for c in want]
