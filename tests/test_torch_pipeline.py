"""The GPipe pipeline over ranks (``repro_torch.train.pipeline``) against the
sequential layer stack, and the stack against the JAX package.

As ``tests/pipeline_check.py`` runs the JAX pipeline: reduced smollm-135m
with 8 layers, B = 8, S = 32, 4 microbatches, float32, here over 4 gloo
ranks on the CPU (2 layers per stage), every rank spawned by
``repro_torch.launch.dist.run_ranks``.
Tolerances: the pipelined output within 1e-5·max|y| of the port's
sequential ``stack_forward`` on the same weights, and the gradient of
sum(y²) for every layer's parameters (and for ``x``) within 1e-4·max|g|
per tensor; the sequential stack within 1e-5·max|y| of JAX's
``stack_forward``. On a GPU (``cuda``): 2 gloo ranks sharing the card,
each payload staged through pinned host memory, against the sequential
stack on the card.

The rank body is this module's :func:`pipeline_rank`; JAX is imported
inside the tests only, so a spawned rank loads no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.dist import run_ranks
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import trainable
from repro_torch.models.transformer import stack_forward
from repro_torch.train.pipeline import (make_pipelined_forward, pipeline_bubble_fraction,
                                        stage_slice)

from test_torch_models import jax_params, port_config

Y_REL = 1e-5  # forward within Y_REL·max|y|
G_REL = 1e-4  # gradients within G_REL·max|g| per tensor
B, S, N_MB, L = 8, 32, 4, 8


def grads_of(layers, named, x, y):
    """{name: gradient} of sum(y²) over ``named`` (global layer names) and x."""
    out = torch.autograd.grad((y ** 2).sum(), [x] + [p for _, p in named])
    return {"x": out[0]} | {n: g for (n, _), g in zip(named, out[1:])}


def pipeline_rank(group, cfg, tree, x, n_microbatches):
    """One rank of the pipeline: its stage of the layers, the pipelined
    forward of ``x`` and the gradients of sum(y²) for its layers and x."""
    torch.set_num_threads(1)  # ranks share the host with each other and other tests
    model = params_from_jax(cfg, tree, device=group.device)
    sl = stage_slice(cfg.n_layers, group)
    layers = model.layers[sl]
    named = [(f"{sl.start + int(n.split('.')[0])}.{n.split('.', 1)[1]}", p)
             for n, p in layers.named_parameters()]
    pipe = make_pipelined_forward(cfg, group, n_microbatches)
    xt = torch.from_numpy(x).to(group.device).requires_grad_(True)
    y = pipe(layers, xt, torch.arange(x.shape[1], device=group.device))
    g = grads_of(layers, named, xt, y)
    return {"rank": group.rank, "y": y.detach().cpu().numpy(), "message_s": pipe.link.seconds,
            "grads": {n: t.cpu().numpy() for n, t in g.items()}}


def sequential(cfg, tree, x, device="cpu"):
    model = trainable(params_from_jax(cfg, tree, device=device))
    xt = torch.from_numpy(x).to(device).requires_grad_(True)
    y = stack_forward(cfg, model.layers, xt, torch.arange(x.shape[1], device=device))
    g = grads_of(model.layers, list(model.layers.named_parameters()), xt, y)
    return y.detach().cpu().numpy(), {n: t.cpu().numpy() for n, t in g.items()}


def check_ranks(outs, y_seq, g_seq):
    for out in outs:  # every rank holds the whole output and the gradient of x
        assert np.abs(out["y"] - y_seq).max() <= Y_REL * np.abs(y_seq).max(), out["rank"]
        assert out["message_s"] > 0, out["rank"]  # the link timed its messages
    seen = set()
    for out in outs:
        for name, g in out["grads"].items():
            want = g_seq[name]
            assert np.abs(g - want).max() <= G_REL * np.abs(want).max(), (out["rank"], name)
            seen.add(name)
    assert seen == set(g_seq)  # every layer's parameters, once per stage


def case(remat, seed):
    jcfg, tree = jax_params("smollm-135m", seed=seed, n_layers=L)
    cfg = port_config("smollm-135m", n_layers=L, remat=remat)
    x = (np.random.default_rng(seed + 1).standard_normal((B, S, cfg.d_model)) * 0.1).astype(
        np.float32)
    return jcfg, cfg, tree, x


def test_pipeline_over_gloo_ranks_matches_the_sequential_stack(tmp_path):
    import jax.numpy as jnp

    from repro.models.transformer import stack_forward as jax_stack

    world = 4
    jcfg, cfg, tree, x = case("none", seed=94)
    y_seq, g_seq = sequential(cfg, tree, x)
    y_jax = np.asarray(jax_stack(jcfg, tree["layers"], jnp.asarray(x), jnp.arange(S)))
    assert np.abs(y_seq - y_jax).max() <= Y_REL * np.abs(y_jax).max()
    outs = run_ranks(pipeline_rank, world, "gloo", ["cpu"] * world,
                     init_file=str(tmp_path / "store"), timeout_s=240,
                     args=(cfg, tree, x, N_MB))
    assert [o["rank"] for o in outs] == list(range(world))
    check_ranks(outs, y_seq, g_seq)
    for out in outs:  # each stage's own layers only
        layers = {int(n.split(".")[0]) for n in out["grads"] if n != "x"}
        per = L // world
        assert layers == set(range(out["rank"] * per, (out["rank"] + 1) * per))


def test_bubble_fraction_and_stage_split():
    from repro.train.pipeline import pipeline_bubble_fraction as jax_bubble

    for p, n in ((4, 4), (2, 8), (8, 1)):
        assert pipeline_bubble_fraction(p, n) == jax_bubble(p, n)

    class Group:
        n_devices, rank = 4, 2

    assert stage_slice(8, Group) == slice(4, 6)
    with pytest.raises(ValueError, match="pipeline stages"):
        stage_slice(6, Group)
    with pytest.raises(ValueError, match="pipeline stages"):
        make_pipelined_forward(port_config("smollm-135m", n_layers=6), Group, 2)


@pytest.mark.cuda
def test_pipeline_over_ranks_sharing_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = port_config("smollm-135m", n_layers=L)
    rng = np.random.default_rng(95)
    tree = {"embed": np.zeros((cfg.vocab, cfg.d_model), np.float32),
            "final_norm": {"scale": np.ones(cfg.d_model, np.float32)},
            "layers": {g: {k: (rng.standard_normal((L,) + tuple(t.shape)) * 0.05).astype(
                np.float32) for k, t in grp.items()}
                for g, grp in _one_layer_shapes(cfg).items()}}
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.1).astype(np.float32)
    y_seq, g_seq = sequential(cfg, tree, x, device="cuda")
    outs = run_ranks(pipeline_rank, 2, "gloo", ["cuda"] * 2, init_file=str(tmp_path / "store"),
                     timeout_s=240, args=(cfg, tree, x, N_MB))
    check_ranks(outs, y_seq, g_seq)


def _one_layer_shapes(cfg):
    from repro_torch.models.transformer import init_layer

    return init_layer(cfg, None, torch.device("meta"))
