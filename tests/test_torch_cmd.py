"""Port parity: the command registry of ccv_tpu_torch/nn/cmd.py against
ccv_tpu/nn/cmd.py, on the CPU.

The same names, ids, attributes and capability metadata, and the same
``cmd_ok`` answer on every (command, dtype, format) of the grid; dispatch
through ``cmd`` gives ``ccv_tpu``'s values (float32 within 1e-5 + 1e-5 *
max), the optimizer update commands included; the collectives compute
their sums over two gloo ranks, with the reference's gradients.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as torch_ranks
from ccv_tpu.nn import cmd as jcmd
from ccv_tpu_torch.nn import cmd as tcmd

DTYPES = jcmd.DTYPES_ANY + ("float64", "int16", None)
FORMATS = jcmd.FORMATS_ALL + ("NDHWC", None)


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    tol = 1e-5 + 1e-5 * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol


def test_registry_rows_match():
    jrows, trows = jcmd.commands(), tcmd.commands()
    assert [e.name for e in trows] == [e.name for e in jrows]
    assert tcmd.CMD_COUNT == jcmd.CMD_COUNT == len(trows)
    for j, t in zip(jrows, trows):
        assert (t.id, t.attrs, t.differentiable, t.formats, t.dtypes,
                t.inplace, t.arity) == (j.id, j.attrs, j.differentiable,
                                        j.formats, j.dtypes, j.inplace,
                                        j.arity), t.name
        assert tcmd.cmd_name(t.id) == jcmd.cmd_name(j.id) == t.name
        assert getattr(tcmd, t.name) == getattr(jcmd, j.name)
        assert tcmd.cmd_attr(t.id, tcmd.CMD_ATTR_PASSTHROUGH) == \
            jcmd.cmd_attr(j.id, jcmd.CMD_ATTR_PASSTHROUGH)


@pytest.mark.parametrize("name", [e.name for e in jcmd.commands()])
def test_cmd_ok_grid(name):
    for dtype, fmt in itertools.product(DTYPES, FORMATS):
        want = jcmd.cmd_ok(name, dtype=dtype, format=fmt)
        assert tcmd.cmd_ok(name, dtype=dtype, format=fmt) == want
        if dtype is not None and hasattr(torch, dtype):
            assert tcmd.cmd_ok(name, dtype=getattr(torch, dtype),
                               format=fmt) == want
    for i, o in itertools.product(range(3), range(3)):
        assert tcmd.cmd_allow_inplace(name, i, o) == \
            jcmd.cmd_allow_inplace(name, i, o)


def test_cmd_ok_refusals():
    assert not tcmd.cmd_ok("CCV_NNC_NOT_A_COMMAND_FORWARD")
    assert not tcmd.cmd_ok("CCV_NNC_GEMM_FORWARD", backend="xla")
    for backend in tcmd.BACKENDS:
        assert tcmd.cmd_ok("CCV_NNC_GEMM_FORWARD", backend=backend)


def test_dispatch_matches_ccv_tpu():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal((5, 3)).astype(np.float32)
    for name, args in (("CCV_NNC_GEMM_FORWARD", (a, b)),
                       ("CCV_NNC_RELU_FORWARD", (a,)),
                       ("CCV_NNC_SOFTMAX_FORWARD", (a,)),
                       ("CCV_NNC_EWEXP_FORWARD", (a,))):
        want = jcmd.cmd(name)(*map(jnp.asarray, args))
        _close(tcmd.cmd(name)(*map(torch.from_numpy, args)), want)
        _close(tcmd.cmd(getattr(tcmd, name))(*map(torch.from_numpy, args)),
               want)
    x = torch.from_numpy(a)
    assert tcmd.cmd("CCV_NNC_NOOP_FORWARD")(x) is x


STEPS = {
    "CCV_NNC_SGD_FORWARD": (3, {"rate": 0.1, "decay": 0.01}),
    "CCV_NNC_ADAM_FORWARD": (4, {"step": 3, "rate": 0.01, "decay": 0.02}),
    "CCV_NNC_ADAMW_FORWARD": (4, {"step": 2, "rate": 0.01}),
    "CCV_NNC_LAMB_FORWARD": (4, {"step": 5, "rate": 0.02, "decay": 0.1}),
    "CCV_NNC_RMSPROP_FORWARD": (4, {"rate": 0.01, "decay": 0.01}),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_optimizer_update_commands(name):
    n, kw = STEPS[name]
    rng = np.random.default_rng(1)
    args = [rng.standard_normal((6, 4)).astype(np.float32) for _ in range(n)]
    args[-1] = np.abs(args[-1]) if n == 4 else args[-1]  # v >= 0
    want = jcmd.cmd(name)(*map(jnp.asarray, args), **kw)
    got = tcmd.cmd(name)(*map(torch.from_numpy, args), **kw)
    for g, w in zip(got, want):
        _close(g, w)
    if name == "CCV_NNC_SGD_FORWARD":
        kw = dict(kw, nesterov=True)
        want = jcmd.cmd(name)(*map(jnp.asarray, args), **kw)
        got = tcmd.cmd(name)(*map(torch.from_numpy, args), **kw)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.fixture(scope="module")
def comm_ranks(tmp_path_factory):
    rng = np.random.default_rng(3)
    x, w = (rng.standard_normal((2, 5)).astype(np.float32)
            for _ in range(2))
    return x, w, torch_ranks.run(torch_ranks.comm_commands, 2,
                                 tmp_path_factory.mktemp("comm"), x, w)


@pytest.mark.parametrize("name", ["CCV_NNC_COMM_ALLREDUCE_FORWARD",
                                  "CCV_NNC_COMM_BROADCAST_FORWARD",
                                  "CCV_NNC_COMM_REDUCE_FORWARD"])
def test_collectives_wait(comm_ranks, name):
    """Each COMM_* command on two ranks: the sum (root 0's value for the
    broadcast) on both, and the gradient of sum(y * w_r): allreduce's and
    reduce's the sum of the w, broadcast's that sum at root and 0
    elsewhere."""
    x, w, ranks = comm_ranks
    for r, res in enumerate(ranks):
        y, g = res[name]
        bcast = name == "CCV_NNC_COMM_BROADCAST_FORWARD"
        np.testing.assert_allclose(y, x[0] if bcast else x.sum(0),
                                   rtol=0, atol=1e-6)
        want = w.sum(0) * (0.0 if bcast and r != 0 else 1.0)
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-6)
