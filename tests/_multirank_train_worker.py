"""One rank of ``tests/test_torch_multirank_train.py``: joins a gloo world on
the CPU through a file rendezvous (``_multirank_worker.main``) and runs the
port's training under each case's train policy on its shard of the params
and its rows of the batch, against the reference's single-device run
(computed by the parent, passed in as tensors):

* ``collectives``: each autograd collective of ``distributed/sharding.py``
  in a small function whose one-rank autograd the rank computes beside it
  (grads within 1e-6);
* ``loss``: a family's ``loss`` and this rank's block of every grad leaf
  against ``jax.value_and_grad`` of the reference's loss (1e-5, plus one
  bf16 unit in the last place for a bf16 leaf);
* ``train``: 3 steps of ``make_train_step(policy=)``: losses, params and
  moments against the reference's jitted step;
* ``ckpt_save`` / ``ckpt_restore``: a ``TrainState`` saved across the
  ranks, and restored onto another mesh with ``shardings=``.

    python tests/_multirank_train_worker.py JOB.json RANK

Imports only ``torch`` and ``repro_torch``.
"""
import dataclasses
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _multirank_worker  # noqa: E402

TOL = 1e-5
BF16_ULP = 2.0 ** -7
RTOL_OWN = 1e-5


def _close(t, ref, what, tol=TOL):
    """Within ``tol``, plus one bf16 unit in the last place where ``ref``
    is bf16. Returns the largest difference."""
    if tuple(t.shape) != tuple(ref.shape):
        raise AssertionError(f"{what}: shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
    a, b = t.detach().double(), ref.double()
    bar = tol + (BF16_ULP * b.abs() if ref.dtype == torch.bfloat16 else 0.0)
    err = (a - b).abs()
    if not bool((err <= bar).all()):
        raise AssertionError(f"{what}: max |diff| {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def _setup(case, mesh, data_dir):
    from repro_torch.configs import get_smoke_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    cfg = reduced(get_smoke_config(case["arch"]), n_layers=case["layers"],
                  dtype="float32")
    # a TrainState is pickled beside the tensors: the parent wrote it
    blob = torch.load(f"{data_dir}/{case['data']}.pt", weights_only=False)
    B, S = blob["batch"]["labels"].shape if "batch" in blob else \
        blob["batches"][0]["labels"].shape
    pol = sh.make_policy(cfg, ShapeConfig("train", S, B, "train"), mesh,
                         "train")
    pol = dataclasses.replace(pol, **case.get("overrides", {}))
    for k, v in case.get("expect", {}).items():
        got = getattr(pol, k)
        if (list(got) if isinstance(got, tuple) else got) != v:
            raise AssertionError(f"policy {k} = {got}, expected {v}")
    specs = sh.make_param_specs(blob["params"], cfg, pol)
    return cfg, blob, pol, specs


def _rows(pol, batch):
    return {k: pol.take_block(v, pol.batch_axes, 0) for k, v in
            batch.items()}


def run_loss(case, mesh, data_dir):
    from repro_torch.bridge import tree_flatten, tree_unflatten
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import build_model
    cfg, blob, pol, specs = _setup(case, mesh, data_dir)
    local = sh.shard_params(blob["params"], specs, pol)
    live = [p.detach().requires_grad_() for p in tree_flatten(local)]
    loss, metrics = build_model(cfg).loss(
        tree_unflatten(local, live), _rows(pol, blob["batch"]), policy=pol,
        ragged=case["ragged"])
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    worst = max(_close(loss, blob["loss"], "loss"),
                _close(metrics["ce"], blob["ce"], "ce"),
                _close(metrics["aux"], blob["aux"], "aux"))
    refs = [sh.local_block(g, s, pol) for g, s in zip(
        tree_flatten(blob["grads"]), sh.flatten_specs(specs))]
    for i, (g, p, ref) in enumerate(zip(grads, live, refs)):
        g = torch.zeros_like(p) if g is None else g
        worst = max(worst, _close(g, ref, f"grad {i}"))
    return worst


def _codes_close(t_codes, j_codes, t_scale, j_scale, what, skip=None,
                 rtol=1e-6):
    """int8 moments: scales within ``rtol`` relative, codes within one.
    (Not exact where the scales agree: the global norm summed shard by
    shard moves the clip factor, and with it every clipped gradient, by a
    unit in the last place, which can carry a value across a rounding
    boundary.) ``skip``: the 128-element blocks left out. Returns the
    number of codes that differ."""
    if skip is not None:
        keep = ~skip
        t_codes, j_codes = t_codes[keep], j_codes[keep]
        t_scale, j_scale = t_scale[keep], j_scale[keep]
    if not torch.allclose(t_scale, j_scale, rtol=rtol, atol=0):
        rel = (t_scale - j_scale).abs() / j_scale.abs()
        raise AssertionError(f"{what}: scales differ by {float(rel.max())}"
                             f" relative")
    if t_codes.numel() and (t_codes.int() - j_codes.int()).abs().max() > 1:
        raise AssertionError(f"{what}: codes differ by more than one")
    return int((t_codes != j_codes).sum())


def _held_state(state, ref, specs, pol, what, int8, skip=None, rtol=1e-6):
    """Params (and fp32 moments) within 1e-5 of this rank's blocks of the
    reference's, int8 moments (replicated) by :func:`_codes_close`, but
    for the blocks ``skip`` names (per leaf, as (n_blocks,) bools)."""
    from repro_torch.bridge import tree_flatten
    from repro_torch.distributed import sharding as sh
    flat = sh.flatten_specs(specs)
    worst = 0.0
    for i, (t, r, s) in enumerate(zip(tree_flatten(state.params),
                                      tree_flatten(ref.params), flat)):
        worst = max(worst, _close(t, sh.local_block(r, s, pol),
                                  f"{what} param {i}"))
    tl = [tree_flatten(x) for x in state.opt[1:]]
    rl = [tree_flatten(x) for x in ref.opt[1:]]
    flips = total = 0
    for i, s in enumerate(flat):
        if int8:
            for k in (0, 1):
                flips += _codes_close(tl[k][i], rl[k][i], tl[k + 2][i],
                                      rl[k + 2][i], f"{what} moment {k} "
                                      f"of {i}", None if skip is None
                                      else skip[i], rtol)
                total += tl[k][i].numel()
        else:
            for k in (0, 1):
                worst = max(worst, _close(tl[k][i], sh.local_block(
                    rl[k][i], s, pol), f"{what} moment {k} of {i}"))
    if int8:
        left = 0 if skip is None else sum(int(m.sum()) * 128 for m in skip)
        print(f"{what}: {flips} of {total - 2 * left} int8 moment codes "
              f"one off the reference's ({2 * left} in the blocks left "
              f"out)", flush=True)
    return worst


def _flipped_blocks(fns, state, rows, grads_ref, pol, ragged, block):
    """The int8 compressed gradient of the step at ``state``, recomputed
    here as the step computes it (the same ops: it is deterministic),
    against the reference's raw gradient compressed under the policy: per
    leaf, the (n_blocks,) bools of the 128-element blocks of the whole leaf
    that hold a code that differs (a gradient a few float units off
    crosses a rounding boundary and moves by a whole unit of its tensor's
    scale), and the count of such codes, at most one in a thousand."""
    from repro_torch.bridge import tree_flatten, tree_unflatten
    from repro_torch.distributed import sharding as sh
    from repro_torch.train import compress_grads_int8
    leaves = tree_flatten(state.params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, _ = fns.loss(tree_unflatten(state.params, live), rows, policy=pol,
                       ragged=ragged)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    own = compress_grads_int8(tree_unflatten(state.params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)]), pol)
    ref = compress_grads_int8(grads_ref, pol)
    def codes(t, s):               # the int8 codes of the whole leaf
        t = sh.gather_global(t, s, pol).reshape(-1)
        return torch.round(t / torch.clamp(t.abs().amax() / 127.0,
                                           min=1e-12))

    masks, n, total = [], 0, 0
    for a, b, s in zip(tree_flatten(own), tree_flatten(ref),
                       sh.leaf_specs(pol)):
        diff = codes(a, s) != codes(b, s)
        n, total = n + int(diff.sum()), total + diff.numel()
        pad = -diff.numel() % block
        masks.append(torch.cat([diff, diff.new_zeros(pad)])
                     .reshape(-1, block).any(dim=1))
    # a flip needs a gradient within float noise of a rounding boundary:
    # a wrong gradient (a missed sum over ranks) flips most codes
    if n > total // 1000:
        raise AssertionError(f"{n} of {total} compressed gradient codes "
                             f"differ from the reference's")
    return masks, n


def _shard_state(state, sspecs, pol):
    from repro_torch.bridge import tree_flatten, tree_unflatten
    from repro_torch.distributed import sharding as sh
    return tree_unflatten(state, [
        sh.local_block(t, s, pol).clone() for t, s in
        zip(tree_flatten(state), sh.flatten_specs(sspecs))])


def run_train(case, mesh, data_dir):
    """Three steps of ``make_train_step(policy=)``, each from the
    reference's state before it (the first from the reference's init,
    through ``make_train_state``): the step's loss, and the state after
    the step, against the reference's. int8 moments with int8
    compression: a gradient a few float units off flips its compressed
    code, and one flip moves many codes of a 128-element moment block (its
    scale is the block's, the compressed gradient's the tensor's), so the
    step's own int8 moments are held in the blocks where the compressed
    gradients agree (:func:`_flipped_blocks`; the others are counted),
    their scales within ``RTOL_OWN`` (a compressed gradient's scale is its
    tensor's ``max|g|``, which carries the gradient's float noise), its
    params everywhere within 1e-5; and the whole state is held where the gradients
    are the same: the reference's raw gradient of the step, sharded,
    through ``compress_grads_int8`` and ``apply_updates`` under the
    policy, against the reference's update."""
    from repro_torch.bridge import tree_flatten, tree_unflatten
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, apply_updates,
                                   compress_grads_int8, make_train_state,
                                   make_train_step, train_state_specs)
    cfg, blob, pol, specs = _setup(case, mesh, data_dir)
    int8 = case["moments"] == "int8"
    opt = AdamWConfig(lr=case["lr"], moment_dtype=case["moments"])
    fns = build_model(cfg)
    sspecs = train_state_specs(pol, opt)
    step = make_train_step(
        lambda p, b: fns.loss(p, b, policy=pol, ragged=case["ragged"]), opt,
        policy=pol, grad_compression=case["compression"])
    worst = 0.0
    for n, batch in enumerate(blob["batches"]):
        state = make_train_state(sh.shard_params(blob["params"], specs, pol),
                                 opt, policy=pol) if n == 0 \
            else _shard_state(blob["states"][n], sspecs, pol)
        new, m = step(state, _rows(pol, batch))
        worst = max(worst, _close(m["loss"], blob["losses"][n],
                                  f"step {n} loss"))
        if int(new.opt.step) != n + 1:
            raise AssertionError(f"step {int(new.opt.step)}")
        if int8:
            def raw():
                return tree_unflatten(blob["params"], [
                    sh.local_block(g, s, pol).clone() for g, s in zip(
                        tree_flatten(blob["grads"][n]),
                        sh.flatten_specs(specs))])
            skip, n_flip = _flipped_blocks(fns, state, _rows(pol, batch),
                                           raw(), pol, case["ragged"],
                                           opt.block)
            print(f"step {n} as the step runs it: {n_flip} compressed "
                  f"gradient codes differ from the reference's, in "
                  f"{sum(int(m.sum()) for m in skip)} moment blocks",
                  flush=True)
            worst = max(worst, _held_state(new, blob["states"][n + 1],
                                           specs, pol, f"step {n} (own)",
                                           int8, skip, rtol=RTOL_OWN))
            grads = raw()
            if case["compression"] == "int8":
                grads = compress_grads_int8(grads, pol)
            params, o = apply_updates(state.params, grads, state.opt, opt,
                                      policy=pol)
            new = type(state)(params, o)
        worst = max(worst, _held_state(new, blob["states"][n + 1], specs,
                                       pol, f"step {n}", int8))
    return worst


def _state_specs(case, mesh, data_dir):
    from repro_torch.train import AdamWConfig, train_state_specs
    cfg, blob, pol, specs = _setup(case, mesh, data_dir)
    return blob, pol, train_state_specs(pol, AdamWConfig(
        moment_dtype="float32"))


def run_ckpt_save(case, mesh, data_dir):
    from repro_torch.ft.checkpoint import save_checkpoint
    blob, pol, sspecs = _state_specs(case, mesh, data_dir)
    local = _shard_state(blob["state"], sspecs, pol)
    save_checkpoint(case["path"], local, step=3, extra={"by": "ranks"},
                    shardings=(sspecs, pol))
    return 0.0


def run_ckpt_restore(case, mesh, data_dir):
    from repro_torch.bridge import tree_flatten
    from repro_torch.distributed import sharding as sh
    from repro_torch.ft.checkpoint import restore_checkpoint
    blob, pol, sspecs = _state_specs(case, mesh, data_dir)
    manifest = os.path.join(case["path"], "manifest.json")
    t0 = time.time()
    while not os.path.exists(manifest):      # the other world's save
        if time.time() - t0 > 200:
            raise AssertionError(f"no checkpoint at {case['path']}")
        time.sleep(0.2)
    like = blob["state"]
    got = restore_checkpoint(case["path"], like, shardings=(sspecs, pol),
                             device="cpu")
    n = 0
    for i, (t, g, s) in enumerate(zip(tree_flatten(got), tree_flatten(like),
                                      sh.flatten_specs(sspecs))):
        want = sh.local_block(g, s, pol)
        if t.dtype != want.dtype or not torch.equal(t, want):
            raise AssertionError(f"leaf {i}: not this rank's block")
        n += int(want.numel() != g.numel())
    if n == 0:
        raise AssertionError("no leaf was cut on this mesh")
    return 0.0


# ------------------------------------------------------------ collectives
def _collectives(mesh):
    """{name: the largest difference of the ranks' grads from the one-rank
    autograd's}. Every input is drawn from one seed on every rank; each
    function is written once over the global tensors (one rank) and once
    over this rank's blocks."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as sh
    pol = sh.make_policy(get_smoke_config("qwen3-8b"),
                         ShapeConfig("train", 8, 8, "train"), mesh, "train")
    M, D = pol.model_axis, ("data",)
    m, d = pol.size(M), pol.size(D)
    g = torch.Generator().manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float32)

    def grads(f, *ts):
        ts = [t.detach().clone().requires_grad_() for t in ts]
        return torch.autograd.grad(f(*ts), ts)

    out = {}

    def held(name, mine, ref):
        e = max(float((a - b).abs().max()) for a, b in zip(mine, ref))
        if e > 1e-6:
            raise AssertionError(f"{name}: grads differ by {e}")
        out[name] = e

    blk = pol.take_block
    A, W, C = rnd(6, 4 * m), rnd(4 * m, 5), rnd(6, 5)
    # a row-parallel product's partials summed over model (backward: the
    # identity)
    held("all_reduce", grads(lambda a, w: (pol.all_reduce(
        a @ w, M) * C).sum(), blk(A, M, 1), blk(W, M, 0)),
        [blk(x, M, k) for x, k in zip(
            grads(lambda a, w: ((a @ w) * C).sum(), A, W), (1, 0))])
    # the entry of a column-parallel product (backward: the sum over model)
    X, W2, C2 = rnd(6, 4), rnd(4, 3 * m), rnd(6, 3 * m)
    held("enter", grads(lambda x, w: (pol.all_gather(
        pol.enter(x, M) @ w, M, 1) * C2).sum(), X, blk(W2, M, 1)),
        [x if k is None else blk(x, M, k) for x, k in zip(
            grads(lambda x, w: ((x @ w) * C2).sum(), X, W2), (None, 1))])
    # a gather whose consumers are the same on every rank (backward: this
    # rank's block) and one whose ranks each read their own block of it
    # (backward: the sum over model, then the block)
    T, C3 = rnd(4 * m, 3), rnd(4 * m, 3)
    held("all_gather", grads(lambda t: (pol.all_gather(t, M, 0) ** 2
                                        * C3).sum(), blk(T, M, 0)),
         [blk(x, M, 0) for x in grads(lambda t: (t ** 2 * C3).sum(), T)])
    Cs = [rnd(4, 3) for _ in range(m)]
    me = pol.index(M)
    held("all_gather_summed", grads(lambda t: pol.all_reduce(
        (blk_r(pol.all_gather(t, M, 0, sum_axes=M), (me + 1) % m, m).sin()
         * Cs[me]).sum(), M), blk(T, M, 0)),
        [blk(x, M, 0) for x in grads(lambda t: sum(
            (blk_r(t, (r + 1) % m, m).sin() * Cs[r]).sum()
            for r in range(m)), T)])
    # the same gather as blocks, each block read by each rank in its own
    # way (backward: each block's gradient summed over model, this rank's
    # kept)
    Cb = [[rnd(4, 3) for _ in range(m)] for _ in range(m)]
    held("gather_blocks", grads(lambda t: pol.all_reduce(sum(
        (b.sin() * Cb[me][c]).sum()
        for c, b in enumerate(pol.gather_blocks(t, M, M))), M),
        blk(T, M, 0)),
        [blk(x, M, 0) for x in grads(lambda t: sum(
            (blk_r(t, c, m).sin() * Cb[r][c]).sum()
            for r in range(m) for c in range(m)), T)])
    # a tensor made block by block on every rank, each rank keeping its own
    # block (backward: each block gets its owner's gradient)
    Tk, Ck = rnd(4, 3), [rnd(4, 3) for _ in range(m)]

    def chain(t):
        kept = None
        for c in range(m):
            kept = pol.keep_own(kept, (t * (c + 1)).tanh(), c == me, M)
        return pol.all_reduce((kept * Ck[me]).sum(), M)
    held("keep_own", grads(chain, Tk), grads(lambda t: sum(
        ((t * (c + 1)).tanh() * Ck[c]).sum() for c in range(m)), Tk))
    # this rank's block of a tensor the ranks share (backward: the blocks'
    # gradients gathered)
    Y = rnd(4 * m, 2)
    held("split", grads(lambda y: pol.all_reduce(
        (pol.split(y.exp(), M, 0) * blk(C3[:, :2], M, 0)).sum(), M), Y),
        grads(lambda y: (y.exp() * C3[:, :2]).sum(), Y))
    # an FSDP gather of a weight cut over the batch axis, the batch cut
    # too (backward: the sum over data, then the block: a reduce-scatter)
    Xb, Wf = rnd(4 * d, 3 * d), rnd(3 * d, 5)
    held("fsdp_gather", grads(lambda w: pol.all_reduce(
        (blk(Xb, D, 0) @ sh.gather_leaves(
            {"w": w}, {"w": sh.P(D, None)}, pol)["w"]).tanh().sum(), D),
        blk(Wf, D, 0)),
        [blk(x, D, 0) for x in grads(lambda w: (Xb @ w).tanh().sum(), Wf)])
    # a leaf the spec leaves whole over the batch axis (backward: the sum
    # over data, the data-parallel all-reduce)
    bias = rnd(3 * d)
    held("grad_entry", grads(lambda b: pol.all_reduce(
        ((blk(Xb, D, 0) + sh.grad_entry({"b": b}, {"b": sh.P()}, pol)["b"])
         ** 2).sum(), D), bias),
        grads(lambda b: ((Xb + b) ** 2).sum(), bias))
    # the largest over the ranks (no gradient)
    top = pol.all_reduce(blk(T, M, 0).abs().amax(), M, op="max")
    if float(top) != float(T.abs().amax()):
        raise AssertionError("all_reduce max")
    out["all_reduce_max"] = 0.0
    return out


def blk_r(t, r, n):
    k = t.shape[0] // n
    return t[r * k:(r + 1) * k]


def run_collectives(case, mesh, data_dir):
    return _collectives(mesh)


RUN = {"loss": run_loss, "train": run_train, "ckpt_save": run_ckpt_save,
       "ckpt_restore": run_ckpt_restore, "collectives": run_collectives}


def run_case(case, mesh, data_dir):
    return RUN[case["kind"]](case, mesh, data_dir)


if __name__ == "__main__":
    _multirank_worker.main(run_case)
