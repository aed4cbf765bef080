"""Rank bodies of the port's parallel tests, and ``run``, which spawns them
(no test of its own: tests/test_torch_parallel_*.py and test_torch_cmd.py
import it).

Each rank is a fresh process (``torch.multiprocessing``, spawn) on gloo
with a ``file://`` store in the test's temporary directory and one
intra-op thread; it imports torch and ccv_tpu_torch only, never jax. A
body takes (rank, world, *args) with numpy arguments and returns what the
test compares (numpy, floats), which ``run`` collects in rank order. A
failed rank fails ``run``.
"""

import os
import time

import torch
import torch.multiprocessing as mp

RUN_TIMEOUT = 120.0  # seconds for a whole spawn, start-up included
WMT = dict(layers=1, heads=2, head_dim=8, ff=32, max_len=12)  # wmt_step


def _entry(rank, world, store, fn, args):
    torch.set_num_threads(1)
    from ccv_tpu_torch.parallel import distributed
    distributed.init("gloo", f"file://{store}", world, rank)
    try:
        torch.save(fn(rank, world, *args), f"{store}.out{rank}")
    finally:
        torch.distributed.destroy_process_group()


def run(fn, world, tmp_path, *args):
    """fn(rank, world, *args) on ``world`` gloo ranks; their results."""
    store = os.path.join(str(tmp_path), f"store-{world}-{time.time_ns()}")
    ctx = mp.start_processes(_entry, args=(world, store, fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RUN_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} on {world} ranks did not end "
                               f"in {RUN_TIMEOUT} s")
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(f"{store}.out{r}", weights_only=False)
            for r in range(world)]


def _np(t):
    return t.detach().cpu().numpy()


def _mesh(axes):
    from ccv_tpu_torch.parallel import mesh
    return mesh.make_mesh(axes, "cpu")


# -- the collectives ------------------------------------------------------

def collectives(rank, world, x, x2, w, w_gather, w_scatter):
    """Each collective of parallel.mesh on this rank's block, its output
    and the gradient of sum(output * w's block) by the reference's rules;
    then the Megatron pair under a loss every rank repeats."""
    from ccv_tpu_torch.nn import cmd
    from ccv_tpu_torch.parallel import mesh as M
    ring = [(i, (i + 1) % world) for i in range(world)]
    cases = {
        "allreduce": (lambda t: M.comm_allreduce(t), x, w),
        "broadcast": (lambda t: M.comm_broadcast(t, root=1), x, w),
        "reduce": (lambda t: M.comm_reduce(t), x, w),
        "all_gather": (lambda t: M.all_gather(t), x, w_gather),
        "reduce_scatter": (lambda t: M.reduce_scatter(t), x2, w_scatter),
        "ppermute": (lambda t: M.ppermute(t, None, ring), x, w),
        "ppermute_partial": (lambda t: M.ppermute(t, None, [(0, 2)]), x, w),
    }
    out = {}
    for name, (fn, xs, ws) in cases.items():
        xl = torch.tensor(xs[rank], requires_grad=True)
        y = fn(xl)
        (y * torch.tensor(ws[rank])).sum().backward()
        out[name] = (_np(y), _np(xl.grad))
    # the registry's COMM_* entries are these collectives
    t = torch.tensor(x[rank])
    out["cmd"] = {name: _np(cmd.cmd(f"CCV_NNC_COMM_{name}_FORWARD")(t))
                  for name in ("ALLREDUCE", "BROADCAST", "REDUCE")}
    # Megatron's pair: x[0] on every rank, every rank's loss sum(y * w[0])
    xl = torch.tensor(x[0], requires_grad=True)
    y = M.reduce_from(M.copy_to(xl, None) * (rank + 1.0), None)
    (y * torch.tensor(w[0])).sum().backward()
    out["pair"] = (_np(y), _np(xl.grad))
    xl = torch.tensor(x[rank], requires_grad=True)
    y = M.gather_from(xl, None, -1)
    (y * torch.tensor(w_gather[0].transpose(1, 0, 2).reshape(
        x.shape[1], -1))).sum().backward()
    out["gather_from"] = (_np(y), _np(xl.grad))
    return out


def permute_cuda(rank, world, x, w):
    """ppermute round the ring on a CUDA tensor over gloo (staged through
    pinned host memory): output, the gradient of sum(y * w's row) (the
    inverse permutation), and the staging copies."""
    from ccv_tpu_torch.parallel import mesh as M
    dev = torch.device("cuda", 0)
    M.STAGED.update(copies=0, bytes=0)
    ring_ = [(i, (i + 1) % world) for i in range(world)]
    xl = torch.tensor(x[rank], device=dev, requires_grad=True)
    y = M.ppermute(xl, None, ring_)
    (y * torch.tensor(w[rank], device=dev)).sum().backward()
    torch.cuda.synchronize()
    return (y.device.type, _np(y), _np(xl.grad), dict(M.STAGED))


def comm_commands(rank, world, x, w):
    """The three COMM_* commands on this rank's row: output and the
    gradient of sum(y * w's row)."""
    from ccv_tpu_torch.nn import cmd
    out = {}
    for name in ("ALLREDUCE", "BROADCAST", "REDUCE"):
        full = f"CCV_NNC_COMM_{name}_FORWARD"
        xl = torch.tensor(x[rank], requires_grad=True)
        y = cmd.cmd(full)(xl)
        (y * torch.tensor(w[rank])).sum().backward()
        out[full] = (_np(y), _np(xl.grad))
    return out


# -- ring attention -------------------------------------------------------

def ring(rank, world, cases):
    """For each case (q, k, v, w, causal, mesh axes): ring_attention on
    this rank's block (batch split over 'data' when the mesh has it, the
    sequence over 'seq'), its output block and the gradients of sum(out *
    w's block) for q, k, v."""
    from ccv_tpu_torch.parallel import mesh as M
    from ccv_tpu_torch.parallel.sequence import ring_attention
    res = []
    for q, k, v, w, causal, axes in cases:
        mesh = _mesh(axes)
        place = tuple(M.Shard(0) if n == "data" else M.Shard(1)
                      for n in mesh.mesh_dim_names)
        ql, kl, vl = (M.local_shard(torch.tensor(a), mesh, place)
                      .clone().requires_grad_(True) for a in (q, k, v))
        out = ring_attention(ql, kl, vl, mesh, "seq", is_causal=causal)
        (out * M.local_shard(torch.tensor(w), mesh, place)).sum().backward()
        res.append((_np(out), _np(ql.grad), _np(kl.grad), _np(vl.grad)))
    return res


# -- GPipe and expert parallelism -----------------------------------------

def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_and_moe(rank, world, pipe_w, pipe_b, x_mb, moe_params, moe_cfg,
                     moe_x):
    """gpipe over 4 stages (output, and the gradients of sum(out^2) for
    this rank's stage); the expert-parallel MoE forward (output, aux loss,
    and the gradients of sum(out^2) + aux for this rank's experts and the
    router)."""
    from ccv_tpu_torch.nn import moe
    from ccv_tpu_torch.parallel import pipeline
    from ccv_tpu_torch.parallel.mesh import local_shard
    res = {}
    mesh = _mesh({"stage": world})
    params = {"w": torch.tensor(pipe_w), "b": torch.tensor(pipe_b)}
    place = pipeline.stage_params_sharding(params, mesh)
    local = {k: local_shard(v, mesh, place[k]).clone().requires_grad_(True)
             for k, v in params.items()}
    out = pipeline.gpipe(_stage_fn, local, torch.tensor(x_mb), mesh)
    (out ** 2).sum().backward()
    res["gpipe"] = (_np(out), _np(local["w"].grad), _np(local["b"].grad))

    emesh = _mesh({"expert": world})
    cfg = moe.MoEConfig(**moe_cfg)
    whole = {k: torch.tensor(v) for k, v in moe_params.items()}
    mine = {k: v.requires_grad_(True) for k, v in
            moe.shard_params(whole, emesh, "expert").items()}
    out, aux = moe.forward(mine, cfg, torch.tensor(moe_x),
                           expert=(emesh, "expert"))
    ((out ** 2).sum() + aux).backward()
    res["moe"] = (_np(out), float(aux.detach()),
                  {k: _np(v.grad) for k, v in mine.items()},
                  {k: str(p) for k, p in
                   moe.shardings(whole, emesh, "expert").items()})
    return res


# -- data parallelism -----------------------------------------------------

def sequential_fits(rank, world, cases):
    """For each case (layer specs, parameters, states, x, y, sgd's
    keywords, loss): ``Sequential.set_data_parallel(world)`` and one fit
    on the whole batch; (loss, parameters, layer states) after it. Then
    what compiling the last model with a loss not marked
    ``global_batch_loss`` raised (None: nothing)."""
    from ccv_tpu_torch.nn import layers as L
    from ccv_tpu_torch.nn import model, optimizers
    res = []
    for layers, params, state, x, y, opt_kw, loss in cases:
        m = model.Sequential([getattr(L, name)(**kw) for name, kw in layers])
        m.build(x.shape, device="cpu")
        m.params = model.params_from_jax(params, "cpu")
        m.state = model.params_from_jax(state, "cpu")
        m.compile(optimizers.sgd(**opt_kw), loss)
        m.set_data_parallel(world)
        got = m.fit(x, y)
        res.append((got, [_np(t) for t in optimizers.leaves(m.params)],
                    [_np(t) for t in optimizers.leaves(m.state)]))
    try:
        m.compile(optimizers.sgd(**opt_kw), lambda out, fit: out.mean())
    except ValueError as e:
        return res, str(e)
    return res, None


def batch_norm_axes(rank, world, cases):
    """For each case (x, mesh axes, batch norm's axis, the statistics'
    shape, {mesh axis: the statistics' dimension it splits}): batch norm
    in training on this rank's block of x (split on dimension 0 over
    'data', 1 over 'seq', as ``sharded`` says), from zero mean and unit
    variance; (y, new mean, new variance, the rank's mesh coordinates)."""
    from ccv_tpu_torch.nn import ops
    from ccv_tpu_torch.parallel import data, mesh as M
    res = []
    for x, axes, axis, stat_shape, stat_split in cases:
        mesh = _mesh(axes)
        names = mesh.mesh_dim_names
        place = tuple(M.Shard(0) if n == "data" else M.Shard(1)
                      for n in names)
        stat_place = tuple(M.Shard(stat_split[n]) if n in stat_split
                           else M.Replicate() for n in names)
        xl = M.local_shard(torch.tensor(x), mesh, place)
        mean, var = (M.local_shard(t, mesh, stat_place) for t in (
            torch.zeros(stat_shape), torch.ones(stat_shape)))
        dims = [(d, mesh.get_group(a)) for d, a in ((0, "data"), (1, "seq"))
                if a in names]
        c = x.shape[-1]
        with data.sharded(*dims):
            y, m, v = ops.batch_norm(xl, torch.ones(c), torch.zeros(c), mean,
                                     var, is_training=True, axis=axis)
        res.append((_np(y), _np(m), _np(v),
                    {n: mesh.get_local_rank(n) for n in names}))
    return res


def wmt_step(rank, world, files, one_rank=False):
    """One float32 wmt step (``wmt.train_step``, dropout 0.1) on the 8
    sentence pairs of ``files`` (src, tgt, src-vocab, tgt-vocab): this
    rank's rows over the gloo group, or with ``one_rank`` all of them on
    one rank; (loss, the step's gradients, the parameters after). Over the
    group, then one step of the CLI ``wmt --data-parallel world`` (bf16):
    its loss and parameters."""
    from ccv_tpu_torch.bin import wmt
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.nn import optimizers
    src, tgt, out, sv, tv = wmt.read_pairs(*files, WMT["max_len"])
    cfg = tfm.TransformerConfig(vocab_size=sv, tgt_vocab_size=tv,
                                dropout=0.1, dtype=torch.float32, **WMT)
    params = tfm.init_encoder_decoder(torch.Generator().manual_seed(0), cfg)
    opt = optimizers.adam(rate=1e-4)
    state = opt.init(params)
    n = len(src) // world
    rows = slice(None) if one_rank else slice(rank * n, (rank + 1) * n)
    loss = wmt.train_step(
        params, opt, state, cfg,
        tuple(torch.from_numpy(a[rows]) for a in (src, tgt, out)),
        sv - 1, tv - 1, torch.Generator().manual_seed(1),
        group=None if one_rank else torch.distributed.group.WORLD)
    ps = optimizers.leaves(params)
    res = (float(loss), [_np(p.grad) for p in ps], [_np(p) for p in ps])
    if one_rank:
        return res
    argv = ["--src", files[0], "--tgt", files[1], "--src-vocab", files[2],
            "--tgt-vocab", files[3], "--layers", str(WMT["layers"]),
            "--dim", str(WMT["heads"] * WMT["head_dim"]),
            "--heads", str(WMT["heads"]), "--ff", str(WMT["ff"]),
            "--max-len", str(WMT["max_len"]), "--batch", str(len(src)),
            "--device", "cpu", "--data-parallel", str(world),
            "--dist-backend", "gloo"]
    cli_loss, cli_params = wmt.run(argv)
    return res + (cli_loss, [_np(p) for p in optimizers.leaves(cli_params)])


# -- the composed LM step -------------------------------------------------

def lm_steps(rank, world, tree, cfg_kw, ids, meshes, odd_tree):
    """For each mesh: one LM training step, this rank's rows and sequence
    slice, Megatron blocks on 'model', ring attention on 'seq' where the
    mesh has it; the loss, this rank's gradient blocks (allreduced over
    'data' and 'seq'), the dimension each leaf is split on over 'model'
    (-1: whole) and the rank's mesh coordinates. Then the placements of
    ``odd_tree`` (dimensions that do not divide) on the last mesh, as
    PartitionSpec-like tuples."""
    from ccv_tpu_torch.models import transformer as tfm
    from ccv_tpu_torch.nn import optimizers
    from ccv_tpu_torch.parallel import data, mesh as M
    cfg = tfm.TransformerConfig(**cfg_kw, dtype=torch.float32)
    params = tfm.params_from_jax(tree, "cpu")
    ids = torch.tensor(ids, dtype=torch.int64)
    res = []
    for axes in meshes:
        mesh = _mesh(axes)
        names = mesh.mesh_dim_names
        local = tfm.shard_params(params, mesh, cfg)
        place = tuple(M.Shard(0) if n == "data" else
                      M.Shard(1) if n == "seq" else M.Replicate()
                      for n in names)
        x = M.local_shard(ids[:, :-1], mesh, place)
        y = M.local_shard(ids[:, 1:], mesh, place)
        dims = [(d, mesh.get_group(a)) for d, a in ((0, "data"), (1, "seq"))
                if a in names]
        ring = tfm.RingSpec(mesh, "seq", "data", "model") \
            if "seq" in names else None
        tensor = None if ring else tfm.TensorSpec(mesh, "model")
        with data.sharded(*dims):
            logits = tfm.lm_forward(local, cfg, x, ring=ring, tensor=tensor)
            loss = tfm.cross_entropy(logits, y)
        grads = torch.autograd.grad(loss, optimizers.leaves(local))
        groups = [g for _, g in dims]
        grads = data.allreduce_grads(list(grads), groups)
        for g in groups:
            loss = M.comm_allreduce(loss.detach(), g)
        split = optimizers.tree_zip(
            lambda p, pl: torch.tensor(next(
                (q.dim for n, q in zip(names, pl)
                 if n == "model" and isinstance(q, M.Shard)), -1)),
            params, tfm.shardings(params, mesh, cfg))
        res.append((float(loss), [_np(g) for g in grads],
                    [int(d) for d in optimizers.leaves(split)],
                    {n: mesh.get_local_rank(n) for n in names}))
    odd = tfm.params_from_jax(odd_tree, "cpu")
    specs = optimizers.tree_zip(
        lambda p, pl: torch.tensor([next((i for i, q in enumerate(pl)
                                          if isinstance(q, M.Shard)
                                          and q.dim == d), -1)
                                    for d in range(p.ndim)]),
        odd, tfm.shardings(odd, mesh))
    return res, [_np(t).tolist() for t in optimizers.leaves(specs)]
