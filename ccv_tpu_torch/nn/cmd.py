"""Command registry (counterpart of ccv_tpu/nn/cmd.py; reference:
lib/nnc/ccv_nnc_cmd.c: ccv_nnc_cmd_name:740, ccv_nnc_cmd_ok:750, the
ccv_nnc_cmd.inc table).

The same command names, ids (registration order) and capability metadata
as ``ccv_tpu``'s: each entry maps a ``CCV_NNC_*_FORWARD`` name to the
port's function for its forward (``nn.ops``, ``nn.optimizers``' update
steps, ``nn.compression``'s LSSC), with the formats and dtypes it takes
(dtype names as torch names them: ``torch.bfloat16`` is "bfloat16"), the
(input, output) pairs that may alias, and its arity. The backend here is
PyTorch ("torch", "cuda" or "cpu" in ``cmd_ok``); "differentiable" means
autograd runs through the forward.

The three collectives (``COMM_ALLREDUCE``, ``COMM_BROADCAST``,
``COMM_REDUCE``) are ``parallel.mesh``'s ``comm_*`` over a process group
(``group=``, default the world), differentiable by the reference's rules.

    >>> cmd("CCV_NNC_GEMM_FORWARD")(a, b)
    >>> cmd_ok("CCV_NNC_CONVOLUTION_FORWARD", dtype=torch.float16,
    ...        format="NCHW")
    True
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from ccv_tpu_torch.nn import compression as _compression
from ccv_tpu_torch.nn import ops
from ccv_tpu_torch.nn import optimizers as _opt
from ccv_tpu_torch.parallel import mesh as _mesh

# attribute bits (ccv_nnc.h:63-65)
CMD_ATTR_PASSTHROUGH = 0x01
CMD_ATTR_OUTPUT_ONES = 0x02
CMD_ATTR_NULL_IS_ONES = 0x04

DTYPES_FLOAT = ("float32", "bfloat16", "float16")
DTYPES_ANY = DTYPES_FLOAT + ("int32", "int64", "uint8", "int8", "bool")
FORMATS_ALL = ops.FORMATS
FORMATS_NHWC = (ops.FORMAT_NHWC,)
BACKENDS = ("torch", "cuda", "cpu")


@dataclasses.dataclass(frozen=True)
class CmdEntry:
    """One registry row: formats / dtypes are the capability masks,
    ``inplace`` the (input, output) pairs that may alias, ``arity``
    (min inputs, outputs)."""

    id: int
    name: str
    fn: Callable
    attrs: int = 0
    differentiable: bool = True
    formats: Tuple[str, ...] = FORMATS_ALL
    dtypes: Tuple[str, ...] = DTYPES_FLOAT
    inplace: Tuple[Tuple[int, int], ...] = ()
    arity: Tuple[int, int] = (1, 1)


_REGISTRY: Dict[str, CmdEntry] = {}
_BY_ID: Dict[int, CmdEntry] = {}

_EW_INPLACE = ((0, 0),)  # elementwise ops may write onto their first input


def _register(short: str, fn: Callable, attrs: int = 0,
              differentiable: bool = True, **caps):
    name = f"CCV_NNC_{short}_FORWARD"
    entry = CmdEntry(id=len(_REGISTRY) + 1, name=name, fn=fn, attrs=attrs,
                     differentiable=differentiable, **caps)
    _REGISTRY[name] = entry
    _BY_ID[entry.id] = entry
    globals()[name] = entry.id


for _short, _fn, _diff, _caps in [
    ("GEMM", ops.gemm, True, dict(arity=(2, 1))),
    ("ADD", ops.add, True, dict(arity=(2, 1), inplace=_EW_INPLACE)),
    ("MUL", ops.mul, True, dict(arity=(2, 1), inplace=_EW_INPLACE)),
    ("SCALAR_MUL", ops.scalar_mul, True, dict(inplace=_EW_INPLACE)),
    ("CMUL", ops.cmul, True, dict(arity=(2, 1))),
    ("CONVOLUTION", ops.conv2d, True, dict(arity=(2, 1))),
    ("CONVOLUTION_TRANSPOSE", ops.conv2d_transpose, True,
     dict(arity=(2, 1))),
    ("RELU", ops.relu, True, dict(inplace=_EW_INPLACE)),
    ("LEAKY_RELU", ops.leaky_relu, True, dict(inplace=_EW_INPLACE)),
    ("SIGMOID", ops.sigmoid, True, dict(inplace=_EW_INPLACE)),
    ("TANH", ops.tanh, True, dict(inplace=_EW_INPLACE)),
    ("SWISH", ops.swish, True, dict(inplace=_EW_INPLACE)),
    ("GELU", ops.gelu, True, dict(inplace=_EW_INPLACE)),
    ("SOFTMAX", ops.softmax, True, dict(inplace=_EW_INPLACE)),
    ("DROPOUT", ops.dropout, True, dict(arity=(3, 1))),
    ("EWSUM", ops.ewsum, True, dict(arity=(2, 1), inplace=_EW_INPLACE)),
    ("EWPROD", ops.ewprod, True, dict(arity=(2, 1), inplace=_EW_INPLACE)),
    ("EWDIV", ops.ewdiv, True, dict(arity=(2, 1), inplace=_EW_INPLACE)),
    ("EWEXP", ops.ewexp, True, dict(inplace=_EW_INPLACE)),
    ("EWLOG", ops.ewlog, True, dict(inplace=_EW_INPLACE)),
    ("EWSQRT", ops.ewsqrt, True, dict(inplace=_EW_INPLACE)),
    ("EWABS", ops.ewabs, True, dict(inplace=_EW_INPLACE)),
    ("EWNEG", ops.ewneg, True, dict(inplace=_EW_INPLACE)),
    ("CLAMP", ops.clamp, True, dict(inplace=_EW_INPLACE)),
    ("MIN", ops.ewmin, True, dict(arity=(2, 1), inplace=_EW_INPLACE)),
    ("MAX", ops.ewmax, True, dict(arity=(2, 1), inplace=_EW_INPLACE)),
    ("MAX_POOL", ops.max_pool, True, dict(dtypes=DTYPES_ANY)),
    ("AVERAGE_POOL", ops.avg_pool, True, {}),
    ("BATCH_NORM", ops.batch_norm, True, dict(arity=(5, 3))),
    ("LAYER_NORM", ops.layer_norm, True, dict(arity=(1, 1))),
    ("GROUP_NORM", ops.group_norm, True, dict(arity=(1, 1))),
    ("RMSNORM", ops.rmsnorm, True, dict(arity=(2, 1))),
    ("MSE", ops.mse_loss, True, dict(arity=(2, 1))),
    ("MAE", ops.mae_loss, False, dict(arity=(2, 1))),
    ("SMOOTH_L1", ops.smooth_l1_loss, True, dict(arity=(2, 1))),
    ("CATEGORICAL_CROSSENTROPY", ops.categorical_crossentropy, True,
     dict(arity=(2, 1))),
    ("SOFTMAX_CROSSENTROPY", ops.softmax_crossentropy, True,
     dict(arity=(2, 2))),
    ("BINARY_CROSSENTROPY", ops.binary_crossentropy, True,
     dict(arity=(2, 1))),
    ("SIGMOID_BINARY_CROSSENTROPY", ops.sigmoid_binary_crossentropy, True,
     dict(arity=(2, 2))),
    ("REDUCE_SUM", ops.reduce_sum, True, {}),
    ("REDUCE_MEAN", ops.reduce_mean, True, {}),
    ("REDUCE_MAX", ops.reduce_max, True, dict(dtypes=DTYPES_ANY)),
    ("REDUCE_MIN", ops.reduce_min, True, dict(dtypes=DTYPES_ANY)),
    ("REDUCE_NORM2", ops.reduce_norm2, True, {}),
    ("ARGMAX", ops.argmax, False, dict(dtypes=DTYPES_ANY)),
    ("ARGMIN", ops.argmin, False, dict(dtypes=DTYPES_ANY)),
    ("REDUCE_ISNAN", ops.reduce_isnan, False, {}),
    ("FORMAT_TRANSFORM", ops.format_transform, True,
     dict(dtypes=DTYPES_ANY)),
    ("DATATYPE_CONVERSION", ops.datatype_conversion, True,
     dict(dtypes=DTYPES_ANY)),
    ("SET", ops.set_, False, dict(dtypes=DTYPES_ANY, arity=(0, 1))),
    ("MASKED_FILL", ops.masked_fill, True, dict(arity=(2, 1))),
    ("PAD", ops.pad, True, dict(dtypes=DTYPES_ANY)),
    ("INDEX_SELECT", ops.index_select, True,
     dict(dtypes=DTYPES_ANY, arity=(2, 1))),
    ("UPSAMPLE", ops.upsample, True, {}),
    ("HISTOGRAM", ops.histogram, False, {}),
    ("RANDOM_UNIFORM", ops.random_uniform, False, dict(arity=(2, 1))),
    ("RANDOM_NORMAL", ops.random_normal, False, dict(arity=(2, 1))),
    ("NMS", ops.nms, False, dict(arity=(2, 2))),
    ("ROI_ALIGN", ops.roi_align, True,
     dict(arity=(2, 1), formats=FORMATS_NHWC)),
    ("SCALED_DOT_PRODUCT_ATTENTION", ops.scaled_dot_product_attention, True,
     dict(arity=(3, 1), formats=FORMATS_NHWC)),
    ("LSTM", ops.lstm, True, dict(arity=(3, 1), formats=FORMATS_NHWC)),
    ("TRANSPOSE", ops.transpose, True, dict(dtypes=DTYPES_ANY)),
    ("DATA_TRANSFER", ops.data_transfer, True,
     dict(dtypes=DTYPES_ANY, inplace=_EW_INPLACE)),
]:
    _register(_short, _fn, differentiable=_diff, **_caps)

# optimizer updates: per-tensor steps that update their parameter and
# moment slots in place in the reference
for _short, _fn in [("SGD", _opt.sgd_step), ("ADAM", _opt.adam_step),
                    ("ADAMW", _opt.adamw_step), ("LAMB", _opt.lamb_step),
                    ("RMSPROP", _opt.rmsprop_step)]:
    _register(_short, _fn, differentiable=False,
              inplace=((0, 0), (1, 1)), arity=(3, 2))

# the collectives (cmd/comm/ccv_nnc_comm.c:97+): allreduce's backward is an
# allreduce, broadcast's a reduce to root
_register("COMM_ALLREDUCE", _mesh.comm_allreduce, inplace=_EW_INPLACE)
_register("COMM_BROADCAST", _mesh.comm_broadcast)
_register("COMM_REDUCE", _mesh.comm_reduce)

_register("COMPRESSION_LSSC", _compression.lssc_compress,
          differentiable=False, dtypes=("float16", "bfloat16"))

_register("NOOP", lambda *a: a[0] if len(a) == 1 else a,
          attrs=CMD_ATTR_PASSTHROUGH, dtypes=DTYPES_ANY)

CMD_COUNT = len(_REGISTRY)


def dtype_name(dtype) -> str:
    """A torch dtype's name without the module ("bfloat16"); strings pass
    through."""
    return str(dtype).removeprefix("torch.")


def cmd_entry(name_or_id) -> CmdEntry:
    return (_BY_ID[name_or_id] if isinstance(name_or_id, int)
            else _REGISTRY[name_or_id])


def cmd(name_or_id) -> Callable:
    """The command's forward function."""
    return cmd_entry(name_or_id).fn


def cmd_name(cmd_id: int) -> str:
    """ccv_nnc_cmd_name twin (ccv_nnc.h:740)."""
    return _BY_ID[cmd_id].name


def cmd_ok(name_or_id, backend: str = "torch", dtype=None,
           format: Optional[str] = None) -> bool:
    """ccv_nnc_cmd_ok twin (ccv_nnc.h:750): does the backend take the
    command for this dtype (a torch dtype or its name) and format?"""
    try:
        e = cmd_entry(name_or_id)
    except KeyError:
        return False
    if backend not in BACKENDS:
        return False
    if dtype is not None and dtype_name(dtype) not in e.dtypes:
        return False
    if format is not None and format not in e.formats:
        return False
    return True


def cmd_allow_inplace(name_or_id, input_idx: int, output_idx: int) -> bool:
    """ccv_nnc_cmd_allow_inplace twin (ccv_nnc.h:760): may input i alias
    output j?"""
    return (input_idx, output_idx) in cmd_entry(name_or_id).inplace


def cmd_attr(name_or_id, attr: int) -> bool:
    """ccv_nnc_cmd_attr twin: test an attribute bit."""
    return bool(cmd_entry(name_or_id).attrs & attr)


def commands():
    """Every registry entry, in id order (the ccv_nnc_cmd.inc table)."""
    return list(_REGISTRY.values())
