"""The chunked-remat time scan (``repro_torch.models.scan_utils``) and the
three recurrences that run through it (``ssm._ssm_scan``,
``xlstm._mlstm_scan``, ``xlstm._slstm_scan``).

* ``chunk_size`` is JAX's choice: the largest divisor of T not above the
  bound.
* Each scan at T ∈ {1, 7, 24, 160} and chunk bounds 5 and 128, from a
  seeded state: the carry, the outputs and the gradient of every input
  (a seeded cotangent on outputs and carry) bitwise equal to the plain loop
  (``REMAT_CHUNK`` = 1); against the JAX package's scan under ``jax.vjp``,
  its ``chunked_remat_scan`` given the same bound, within 1e-5·max|·| per
  tensor.
* A tuple carry, tuple inputs (time on axis 1, the model's layout) and a
  tuple of outputs, bitwise the plain loop; the bound is ``REMAT_CHUNK``
  as it stands at the call.
* Without a gradient no checkpoint runs; with one, a checkpoint per chunk,
  and the tensors kept outside the chunks are a small part of the plain
  loop's.
* The SSM scan's states go into a stacked list, not written into a
  preallocated tensor: bitwise the old form's forward and gradients (over
  two scan blocks), and no ``CopySlices`` node in its backward graph.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.models import scan_utils, ssm, xlstm

JAX_REL = 1e-5  # against the JAX package's scan: within JAX_REL·max|·| per tensor
B, H, HD, DI, N = 2, 2, 4, 8, 4  # batch, heads, head width, SSM channels, SSM state


def seeded(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def scan_inputs(kind, T, seed=0):
    """Seeded float32 inputs of one of the three scans: the sequences
    (B, T, ...) and the state it starts from."""
    if kind == "ssm":
        dt = np.log1p(np.exp(seeded((B, T, DI), seed + 1)))  # softplus: positive
        a = -np.exp(np.log(np.arange(1, N + 1, dtype=np.float32))[None].repeat(DI, 0)
                    + seeded((DI, N), seed + 2, 0.1))
        return [seeded((B, T, DI), seed), dt.astype(np.float32), seeded((B, T, N), seed + 3),
                seeded((B, T, N), seed + 4), a.astype(np.float32),
                seeded((B, DI, N), seed + 5, 0.5)]
    if kind == "mlstm":
        return ([seeded((B, T, H, HD), seed + i, 0.5) for i in range(3)]
                + [seeded((B, T, H), seed + 3), seeded((B, T, H), seed + 4) + 2.0,
                   seeded((B, H, HD, HD), seed + 5, 0.5), seeded((B, H, HD), seed + 6, 0.5),
                   seeded((B, H), seed + 7, 0.5)])
    d = H * HD
    return [seeded((B, T, 4 * d), seed), seeded((H, HD, 4 * HD), seed + 1, 0.5)] + [
        seeded((B, d), seed + 2 + i, 0.5) for i in range(4)]


def port_scan(kind, args):
    if kind == "ssm":
        h, y = ssm._ssm_scan(*args)
        return [h, y]
    if kind == "mlstm":
        state, y = xlstm._mlstm_scan(*args[:5], tuple(args[5:]))
    else:
        state, y = xlstm._slstm_scan(args[0], args[1], tuple(args[2:]), H, HD)
    return list(state) + [y]


def jax_scan(kind, args):
    from repro.models import ssm as JS
    from repro.models import xlstm as JX

    if kind == "ssm":
        h, y = JS._ssm_scan(*args)
        return [h, y]
    if kind == "mlstm":
        state, y = JX._mlstm_scan(*args[:5], tuple(args[5:]))
    else:
        state, y = JX._slstm_scan(args[0], args[1], tuple(args[2:]), H, HD)
    return list(state) + [y]


def port_run(kind, arrays, cotangents):
    """The scan's outputs (carry tensors and y) and the gradient of
    sum(out · cotangent) with respect to every input."""
    args = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    outs = port_scan(kind, args)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cotangents))
    grads = torch.autograd.grad(loss, args)
    return [o.detach() for o in outs], list(grads)


def cotangents_for(kind, arrays):
    with torch.no_grad():
        outs = port_scan(kind, [torch.from_numpy(a) for a in arrays])
    return [seeded(tuple(o.shape), 100 + i) for i, o in enumerate(outs)]


def assert_bitwise(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32)), (
            what, i, float((a - b).abs().max()))


@pytest.mark.parametrize("T,chunk", [(1, 1), (7, 5), (7, 7), (24, 5), (160, 128), (160, 5),
                                     (128, 128), (300, 128), (97, 128)])
def test_chunk_size_is_the_largest_divisor_up_to_the_bound(T, chunk):
    c = scan_utils.chunk_size(T, chunk)
    assert T % c == 0 and c <= chunk
    assert not any(T % d == 0 for d in range(c + 1, min(chunk, T) + 1))


@pytest.mark.parametrize("kind", ["ssm", "mlstm", "slstm"])
@pytest.mark.parametrize("T", [1, 7, 24, 160])
@pytest.mark.parametrize("chunk", [5, 128])
def test_chunked_scan_is_bitwise_the_plain_loop(kind, T, chunk, monkeypatch):
    arrays = scan_inputs(kind, T)
    cot = cotangents_for(kind, arrays)
    monkeypatch.setattr(scan_utils, "REMAT_CHUNK", chunk)
    got = port_run(kind, arrays, cot)
    monkeypatch.setattr(scan_utils, "REMAT_CHUNK", 1)
    want = port_run(kind, arrays, cot)
    assert_bitwise(got[0], want[0], "outputs")
    assert_bitwise(got[1], want[1], "gradients")


@pytest.mark.parametrize("kind", ["ssm", "mlstm", "slstm"])
@pytest.mark.parametrize("T", [1, 7, 24, 160])
@pytest.mark.parametrize("chunk", [5, 128])
def test_chunked_scan_matches_jax(kind, T, chunk, monkeypatch):
    import jax
    import jax.numpy as jnp

    from repro.models import scan_utils as JU

    arrays = scan_inputs(kind, T)
    cot = cotangents_for(kind, arrays)
    monkeypatch.setattr(scan_utils, "REMAT_CHUNK", chunk)
    got_out, got_grad = port_run(kind, arrays, cot)
    # the JAX scans import chunked_remat_scan when called: give it the same bound
    monkeypatch.setattr(JU, "chunked_remat_scan",
                        functools.partial(JU.chunked_remat_scan, chunk=chunk))
    want_out, vjp = jax.vjp(lambda *a: jax_scan(kind, a), *(jnp.asarray(a) for a in arrays))
    want_grad = vjp([jnp.asarray(c) for c in cot])
    for what, got, want in (("outputs", got_out, want_out), ("gradients", got_grad, want_grad)):
        for i, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            assert g.shape == w.shape, (what, i)
            err = np.abs(g.numpy() - w).max()
            assert err <= JAX_REL * np.abs(w).max(), (what, i, err, np.abs(w).max())


def test_tuples_of_tensors_in_the_model_layout(monkeypatch):
    """A tuple carry, a tuple of (B, T) inputs with time on axis 1 (the
    model's layout) and a tuple of outputs; in chunks of 4 (T = 12), bitwise
    the plain loop, values and gradients, and the outputs stacked on axis 1."""
    def step(carry, x):
        s, p = carry
        s, p = s + x[0], p * x[1]
        return (s, p), (s, 2 * p)

    def run(chunk):
        monkeypatch.setattr(scan_utils, "REMAT_CHUNK", chunk)
        xs = (torch.from_numpy(seeded((3, 12), 1)).requires_grad_(True),
              torch.from_numpy(seeded((3, 12), 2, 0.1) + 1).requires_grad_(True))
        init = (torch.zeros(3, requires_grad=True), torch.ones(3))
        (s, p), (ys, ps) = scan_utils.chunked_remat_scan(step, init, xs)
        grads = torch.autograd.grad((s * 3 + p).sum() + (ys * ps).sum(), xs + init[:1])
        return [s, p, ys, ps], list(grads)

    got, want = run(4), run(1)
    torch.testing.assert_close(got[0][2].detach(),  # the running sums, stacked on axis 1
                               torch.cumsum(torch.from_numpy(seeded((3, 12), 1)), 1))
    assert_bitwise([t.detach() for t in got[0]], [t.detach() for t in want[0]], "outputs")
    assert_bitwise(got[1], want[1], "gradients")


def test_chunk_bound_is_read_at_the_call(monkeypatch):
    """The bound is ``REMAT_CHUNK`` as it stands when the scan is called:
    24 steps under a gradient make 24 / chunk_size(24, bound) checkpoints,
    and none at a bound of 1."""
    calls = []
    real = scan_utils.checkpoint
    monkeypatch.setattr(scan_utils, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    xs = torch.from_numpy(seeded((2, 24), 3)).requires_grad_(True)
    for bound, chunks in ((5, 6), (128, 0), (1, 0), (12, 2)):
        calls.clear()
        monkeypatch.setattr(scan_utils, "REMAT_CHUNK", bound)
        scan_utils.chunked_remat_scan(lambda c, x: (c + x, c), torch.zeros(2), xs)
        assert len(calls) == chunks, (bound, len(calls))


def test_no_gradient_runs_the_plain_loop(monkeypatch):
    calls = []
    real = scan_utils.checkpoint
    monkeypatch.setattr(scan_utils, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    arrays = scan_inputs("mlstm", 24)
    monkeypatch.setattr(scan_utils, "REMAT_CHUNK", 5)  # chunks of 4
    args = [torch.from_numpy(a) for a in arrays]
    with torch.no_grad():
        plain = port_scan("mlstm", [a.requires_grad_(True) for a in args])
    assert not calls
    out = port_scan("mlstm", [a.detach() for a in args])  # grad mode, nothing requires grad
    assert not calls and not out[-1].requires_grad
    out = port_scan("mlstm", [a.detach().requires_grad_(True) for a in args])
    assert len(calls) == 6
    assert_bitwise([o.detach() for o in out], plain, "outputs")


def test_chunks_keep_their_carries_not_each_step(monkeypatch):
    """The tensors the backward keeps outside the chunks (a checkpoint's
    own saved tensors are recomputed) against the plain loop's."""
    arrays = scan_inputs("mlstm", 160)
    kept = {}
    for chunk in (1, 80, 5):
        monkeypatch.setattr(scan_utils, "REMAT_CHUNK", chunk)
        n = [0]

        def pack(t, n=n):
            n[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            port_scan("mlstm", [torch.from_numpy(a).requires_grad_(True) for a in arrays])
        kept[chunk] = n[0]
    C = B * H * HD * HD * 4  # one step's matrix memory, bytes
    assert kept[1] >= 160 * 2 * C, kept  # the plain loop keeps each step's states
    # chunked: outside the checkpoints only the forget gates' log-sigmoid (its input and
    # buffer, (B, T, H) each), computed before the loop
    assert kept[80] == kept[5] == 2 * B * 160 * H * 4, kept


def old_ssm_scan(u, dt_, B_, C_, a, h0):
    """The SSM scan as it was, each step's state written into a
    preallocated tensor."""
    h = h0
    ys = []
    for s in range(0, u.shape[1], ssm.SCAN_BLOCK):
        blk = slice(s, s + ssm.SCAN_BLOCK)
        decay = torch.exp(dt_[:, blk, :, None] * a)
        inp = (dt_[:, blk] * u[:, blk])[..., None] * B_[:, blk, None, :]
        hs = torch.empty_like(decay)
        for t in range(decay.shape[1]):
            h = h * decay[:, t] + inp[:, t]
            hs[:, t] = h
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, C_[:, blk]))
    return h, torch.cat(ys, dim=1)


@pytest.mark.parametrize("chunk", [1, 128])
def test_ssm_states_stacked_equal_the_old_writes(chunk, monkeypatch):
    monkeypatch.setattr(scan_utils, "REMAT_CHUNK", chunk)
    arrays = scan_inputs("ssm", 300)  # two scan blocks: 256 (chunks of 128) and 44 steps
    cot = cotangents_for("ssm", arrays)
    got = port_run("ssm", arrays, cot)
    monkeypatch.setattr(ssm, "_ssm_scan", old_ssm_scan)
    want = port_run("ssm", arrays, cot)
    assert_bitwise(got[0], want[0], "outputs")
    assert_bitwise(got[1], want[1], "gradients")


def graph_nodes(*outputs):
    """The class names of the backward graph's nodes behind ``outputs``."""
    names, seen, todo = set(), set(), [o.grad_fn for o in outputs]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    return names


@pytest.mark.parametrize("chunk", [1, 128])
def test_ssm_backward_graph_holds_no_copy_slices(chunk, monkeypatch):
    monkeypatch.setattr(scan_utils, "REMAT_CHUNK", chunk)
    args = [torch.from_numpy(a).requires_grad_(True) for a in scan_inputs("ssm", 256)]
    names = graph_nodes(*ssm._ssm_scan(*args))
    assert "CopySlices" not in names, sorted(names)
    assert {"UnbindBackward0", "StackBackward0"} <= names, sorted(names)
    assert "CopySlices" in graph_nodes(*old_ssm_scan(*args))  # what the check would catch
