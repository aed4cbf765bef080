"""The port's NLP CLI twins (ccv_tpu_torch.bin.wmt, .iwslt, .imdb) on the
CPU (``--device cpu``), mirroring tests/test_bin_nlp.py with the same
arguments and gates: the wmt demo's loss < 3.5, the iwslt demo's < 3.9,
the imdb demo's accuracy >= 0.9. Their data helpers equal bin/'s.

The wmt gate sits inside the spread of the initial draw: the port's CLI
from its own torch.Generator(0) parameters ends the demo at 3.5066
(``python -m ccv_tpu_torch.bin.wmt --demo --epochs 10 --batch 32 --heads 4
--lr 3e-3 --device cpu``), bin/wmt.py from PRNGKey(0) at 3.4339, and other
initial seeds land either side of 3.5 on both implementations. So the wmt
test starts the port from bin/wmt.py's own initial parameters (ccv_tpu's
PRNGKey(0)) and holds it to the gate and to bin/wmt.py's final loss of the
same run within 2e-2 (bf16 training rounds differently on the two sides).
The port's own init is tested for shapes in test_torch_seq2seq.py.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_tpu.models import transformer as jtf
from ccv_tpu_torch.bin import bin_imdb_shared as t_shared
from ccv_tpu_torch.bin import imdb as t_imdb
from ccv_tpu_torch.bin import iwslt as t_iwslt
from ccv_tpu_torch.bin import wmt as t_wmt
from ccv_tpu_torch.bin import wmt_grad_trial
from ccv_tpu_torch.models import transformer as ttf

BIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "bin")
sys.path.insert(0, BIN)

import bin_imdb_shared as ref_shared  # noqa: E402
import wmt as ref_wmt  # noqa: E402

WMT_DEMO = ["--demo", "--epochs", "10", "--batch", "32", "--heads", "4",
            "--lr", "3e-3"]


def _reference_init(monkeypatch):
    """The port's init_encoder_decoder replaced by a copy of ccv_tpu's
    init from PRNGKey(0), bin/wmt.py's parameters for the same config."""
    def init(generator, cfg):
        jcfg = jtf.TransformerConfig(**{**cfg.__dict__,
                                        "dtype": jnp.bfloat16})
        tree = jtf.init_encoder_decoder(jax.random.PRNGKey(0), jcfg)
        return ttf.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                   device=generator.device)
    monkeypatch.setattr(ttf, "init_encoder_decoder", init)


def _run_reference(module, argv):
    old = sys.argv
    sys.argv = [module.__name__] + argv
    try:
        return module.main()
    finally:
        sys.argv = old


def test_wmt_demo_loss_drops(monkeypatch, capsys):
    _reference_init(monkeypatch)
    loss = t_wmt.main(WMT_DEMO + ["--device", "cpu"])
    want = _run_reference(ref_wmt, WMT_DEMO)
    assert "iter 60: loss" in capsys.readouterr().out
    # synthetic copy task from random init: smoothed CE starts ~ln(64)=4.16
    assert loss < 3.5, loss
    assert abs(loss - want) <= 2e-2, (loss, want)


def test_iwslt_demo_loss_drops(capsys):
    """Noam warm-up, gradient accumulation and greedy decoding all run;
    the loss drops on the copy task."""
    loss = t_iwslt.main(["--demo", "--epochs", "10", "--batch", "32",
                         "--heads", "4", "--big-step", "2", "--device",
                         "cpu"])
    assert loss < 3.9, loss
    assert "demo sequences reproduced" in capsys.readouterr().out


def test_imdb_demo_learns():
    acc = t_imdb.main(["--demo", "--epochs", "2", "--batch", "32",
                       "--max-len", "32", "--layers", "1", "--dim", "32",
                       "--heads", "2", "--device", "cpu"])
    assert acc >= 0.9, acc


def test_data_helpers_equal_the_reference(tmp_path):
    vocab = tmp_path / "v.txt"
    vocab.write_text("the\ncat\nsat\non\nmat\n")
    v = t_wmt.load_vocab(str(vocab))
    assert v == ref_wmt.load_vocab(str(vocab)) == ref_shared.load_vocab(
        str(vocab)) == t_shared.load_vocab(str(vocab))
    for line in ("the cat sat", "a dog on the mat", "", "the " * 20):
        for has_beg in (False, True):
            got, want = (m.encode(line, v, 8, has_beg)
                         for m in (t_wmt, ref_wmt))
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
        got, want = (m.encode(line, v, 8) for m in (t_shared, ref_shared))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for a, b in zip(t_wmt.synthetic_pairs(np.random.default_rng(3)),
                    ref_wmt.synthetic_pairs(np.random.default_rng(3))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_shared.synthetic_corpus(np.random.default_rng(4)),
                    ref_shared.synthetic_corpus(np.random.default_rng(4))):
        np.testing.assert_array_equal(a, b)
    pos, neg = tmp_path / "pos.txt", tmp_path / "neg.txt"
    pos.write_text("the cat sat\non the mat\n")
    neg.write_text("a dog\n")
    args = t_imdb.parser().parse_args(
        ["--train", str(pos), str(neg), "--vocab", str(vocab), "--max-len",
         "6"])
    for a, b in zip(t_shared.load_corpus(args), ref_shared.load_corpus(args)):
        np.testing.assert_array_equal(a, b)


def _text_files(tmp_path):
    words = [f"w{i}" for i in range(12)]
    rng = np.random.default_rng(5)
    (tmp_path / "sv.txt").write_text("\n".join(words) + "\n")
    (tmp_path / "tv.txt").write_text("\n".join(w.upper() for w in words)
                                     + "\n")
    lines = [" ".join(rng.choice(words, rng.integers(2, 7)))
             for _ in range(8)]
    (tmp_path / "s.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "t.txt").write_text("\n".join(line.upper()
                                              for line in lines) + "\n")
    (tmp_path / "tst.txt").write_text("w1 w2 w3\nw4 zzz\n")
    return ["--src", str(tmp_path / "s.txt"), "--tgt", str(tmp_path / "t.txt"),
            "--src-vocab", str(tmp_path / "sv.txt"), "--tgt-vocab",
            str(tmp_path / "tv.txt"), "--max-len", "10", "--layers", "1",
            "--dim", "32", "--heads", "2", "--ff", "32", "--batch", "4",
            "--device", "cpu"]


def test_real_mode_from_text_files(tmp_path, capsys):
    """wmt and iwslt read parallel text and vocab files (the same rows as
    bin/wmt.py's real mode: out = tgt shifted left) and train; iwslt
    decodes a test file."""
    argv = _text_files(tmp_path)
    src, tgt, out, sv, tv = t_wmt.read_pairs(*argv[1:8:2], 10)
    assert sv == tv == 16 and src.shape == tgt.shape == out.shape == (8, 10)
    np.testing.assert_array_equal(out[:, :-1], tgt[:, 1:])
    assert (out[:, -1] == tv - 1).all() and (tgt[:, 0] == tv - 3).all()
    assert np.isfinite(t_wmt.main(argv))
    assert np.isfinite(t_iwslt.main(argv + ["--big-step", "1", "--tst",
                                            str(tmp_path / "tst.txt")]))
    decoded = capsys.readouterr().out.splitlines()[-2:]
    assert all(w.startswith("W") for line in decoded for w in line.split())


def test_data_parallel_is_refused(capsys, monkeypatch):
    """--data-parallel 2 in a world of one process exits naming both, and
    without --dist-backend names the flag (tests/test_torch_parallel_data.py
    runs it on two ranks)."""
    for name in ("CCV_TPU_COORDINATOR", "CCV_TPU_NUM_PROCESSES",
                 "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    for extra, said in ((["--dist-backend", "gloo"],
                         "--data-parallel 2 against a world of 1"),
                        ([], "needs --dist-backend")):
        with pytest.raises(SystemExit) as exc:
            t_wmt.main(["--demo", "--data-parallel", "2", "--device",
                        "cpu"] + extra)
        assert exc.value.code == 2
        assert said in capsys.readouterr().err


@pytest.mark.parametrize("module", [t_wmt, t_iwslt, t_imdb],
                         ids=["wmt", "iwslt", "imdb"])
def test_cli_without_a_device_needs_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        module.main(["--demo"])


def test_synthetic_batch_layout():
    """wmt_grad_trial's (and chip_smoke.py's) synthetic rows follow
    wmt.py's encode: src = tokens, end, pads; tgt = beg, tokens, end, pads
    (8-120 pads a row at T 128); out = tgt shifted left."""
    src, tgt, out = wmt_grad_trial.synthetic_batch(
        np.random.default_rng(0), 64, 128, 300, 280)
    np.testing.assert_array_equal(out[:, :-1], tgt[:, 1:])
    assert (out[:, -1] == 279).all() and (tgt[:, 0] == 277).all()
    for s, t in zip(src, tgt):
        n = int((s != 299).sum())
        assert 8 <= 128 - n <= 120 and (s[n:] == 299).all()
        assert s[n - 1] == 298 and (s[:n - 1] < 296).all()
        assert (t[n:] == 279).all() and t[n - 1] == 278
        assert (t[1:n - 1] < 276).all()
    # short rows keep beg, one token and end
    src, tgt, _ = wmt_grad_trial.synthetic_batch(np.random.default_rng(1),
                                                 8, 12, 300, 280)
    assert ((src != 299).sum(1) >= 3).all()


def test_wmt_grad_trial_runs_on_a_small_model(monkeypatch):
    """The trial's four steps at a small width on the CPU (where the
    kernel route is the plain SDPA, so the kernel and plain columns
    agree exactly) give finite distances, bk and xbk left out."""
    monkeypatch.setattr(wmt_grad_trial, "WIDTHS", dict(
        vocab_size=60, tgt_vocab_size=50, layers=1, heads=2, head_dim=32,
        ff=64, max_len=16))
    res = wmt_grad_trial.trial(9, 31, torch.device("cpu"), batch_size=2)
    assert set(res) >= {"kernel_vs_plain", "kernel_vs_f32", "plain_vs_f32",
                        "f32_kernel_vs_f32"}
    assert set(res["kernel_vs_plain"].values()) == {0.0}
    assert all(np.isfinite(v) and v < 0.5 for v in
               res["kernel_vs_f32"].values())
    assert not any(n.endswith((".bk", ".xbk")) for n in res["plain_vs_f32"])
