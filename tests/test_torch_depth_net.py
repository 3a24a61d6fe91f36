"""The port's PanoDepthNet and its training against salve_tpu's, on the CPU.

Small width: ResNet-18 trunk, embed 64, 1 transformer block, 64x128 panos.
Both sides get the same weights: JAX's init (its 1-D parameters and batch
statistics perturbed from a seed, so no gradient is 0 by construction)
carried across by `depth_net_state_dict_from_flax`. Inputs come from
procedural floors through `iter_layout_depth_batches` (synthetic RGB).
Tolerances:
  * (iii) forward, float32: within 1e-5 of the largest |depth| (measured
    about 5e-7); bfloat16 (both sides in bf16 over float32 weights): within
    2% of the largest |depth| at any pixel, 0.3% on average (measured
    about 0.5% and 0.05%: bf16 keeps 8 bits);
  * (v) one train step against salve_tpu's jitted `make_depth_train_step`
    with optax.adam, in float32 and in float64 (JAX with x64 on): the loss,
    each gradient (as Adam's first moment, 0.1 g on both sides) relative to
    its tensor's largest magnitude, the parameters after Adam and the
    running statistics, within `STEP_BOUNDS` (the test says why float32's
    gradient bound is 2e-2);
  * initializers: each tensor's shape, zero batch-norm scales in the same
    places, std within 10% of the Flax draw's;
  * checkpoints: the port's `.pt` reloads to the saved model's output bit
    for bit; salve_tpu's flax msgpack loads into the provider and matches
    salve_tpu's provider within the bf16 bound above;
  * `cli/train_depth.py` runs on the CPU and writes its checkpoint and
    `.eval.json`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from salve_tpu.models import depth_net as jdn
from salve_tpu.training import depth as jdepth
from salve_tpu_torch.models import depth_net
from salve_tpu_torch.models.weights import depth_net_state_dict_from_flax
from salve_tpu_torch.training import depth as tdepth
from test_torch_depth_synthetic import BIDS, write_floors
# torch keeps its default thread count here (no `torch_threads` fixture): the
# float32 step's early trunk gradients cancel heavily, and how many threads sum
# them moves them against their 2e-2 bound.

HW = (64, 128)
SMALL = dict(num_layers=18, embed_dim=64, num_blocks=1)
LR = 1e-3


def _perturbed(variables, seed: int):
    """JAX variables as numpy, 1-D parameters shifted and batch statistics
    drawn from `seed` (variances positive)."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)
    params = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32) if a.ndim == 1 else a, v["params"])
    stats = jax.tree_util.tree_map(lambda a: np.abs(a + rng.normal(0, 0.1, a.shape)).astype(np.float32),
                                   v["batch_stats"])
    return params, stats


def _port_model(params, stats, compute_dtype: str) -> depth_net.PanoDepthNet:
    sd, config = depth_net_state_dict_from_flax(params, stats, 18)
    config.update(compute_dtype=compute_dtype, input_hw=HW)
    model = depth_net.PanoDepthNet(**config)
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope="module")
def zind(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth_net_zind")
    write_floors(root)
    return root


@pytest.fixture(scope="module")
def batch(zind):
    return next(tdepth.iter_layout_depth_batches(str(zind), list(BIDS), 2, seed=0, synthetic_rgb=True, hw=HW))


@pytest.fixture(scope="module")
def weights():
    model = jdn.PanoDepthNet(**SMALL, compute_dtype=jnp.float32)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, *HW, 3))))(jax.random.PRNGKey(0))
    return variables, _perturbed(variables, 1)


# ------------------------------------------------------------------ (iii) forward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_salve_tpu(weights, batch, dtype):
    params, stats = weights[1]
    jmodel = jdn.PanoDepthNet(**SMALL, compute_dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16)
    ref = np.asarray(jax.jit(lambda x: jmodel.apply({"params": params, "batch_stats": stats}, x))(batch[0]))
    with torch.no_grad():
        got = _port_model(params, stats, dtype).eval()(torch.from_numpy(batch[0])).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == (2, *HW)
    scale = np.abs(ref).max()
    err = np.abs(got - ref)
    if dtype == "float32":
        assert err.max() <= 1e-5 * scale, err.max()
    else:
        assert err.max() <= 0.02 * scale and err.mean() <= 0.003 * scale, (err.max(), err.mean(), scale)


# --------------------------------------------------------------- initializers


def test_initializers_match_flax(weights):
    variables = jax.tree_util.tree_map(np.asarray, weights[0])
    ref, _ = depth_net_state_dict_from_flax(variables["params"], variables["batch_stats"], 18)
    model = depth_net.init_flax_style(depth_net.PanoDepthNet(**SMALL, compute_dtype="float32", input_hw=HW),
                                      torch.Generator().manual_seed(3))
    got = model.state_dict()
    assert sorted(got) == sorted(ref)
    zero_scales = 0
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, k
        if k.endswith("num_batches_tracked"):
            continue
        r = r.numpy()
        if k.endswith(("bias", "running_mean")) or np.all(r == r.flat[0]):
            np.testing.assert_array_equal(g.numpy(), r, err_msg=k)
            zero_scales += k.endswith("weight") and not r.any()
        else:
            assert g.std().item() == pytest.approx(r.std(), rel=0.1), k
    assert zero_scales == 8  # the last batch norm of ResNet-18's 8 blocks


# --------------------------------------------------------------- (v) a train step


# Per dtype: the loss (relative), each gradient (of its tensor's largest
# magnitude), the parameters where |g| is above `big` of its tensor's max,
# the running statistics (absolute).
STEP_BOUNDS = {
    "float32": dict(loss=1e-5, grad=2e-2, big=5e-2, param=1e-6, stats=1e-5),
    "float64": dict(loss=1e-8, grad=1e-6, big=1e-2, param=1e-8, stats=1e-10),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_step_matches_salve_tpu(weights, batch, dtype):
    """One step of salve_tpu's jitted `make_depth_train_step` (optax.adam)
    against the port's, from the same weights and batch.

    In float32 the gradients of some early trunk tensors are sums with
    heavy cancellation on this batch: salve_tpu's float32 step is itself up
    to 9.3e-3 of a tensor's max off its float64 step, the port's 1.5e-3.
    So float32 holds the gradients to 2e-2 and the parameters only where
    |g| > 5e-2 of the tensor's max (elsewhere Adam's first step, about
    lr * sign(g), may flip, so 2 lr); float64 (JAX with x64 on) holds the
    gradients to 1e-6 (measured 4e-7), the loss to 1e-8 (measured 1.1e-9),
    and the parameters to 1e-8 where |g| > 1e-2 of the tensor's max
    (measured 1.3e-9; Adam's eps makes an update of a g near 1e-8 as
    sensitive as the first step's sign). The key projection's bias has a gradient of
    0 in exact arithmetic (softmax over the keys ignores it): it is held to
    1e-6 of the largest gradient on both sides."""
    bound = STEP_BOUNDS[dtype]
    params, stats = weights[1]
    f64 = dtype == "float64"
    with jax.enable_x64(f64):
        jdt = jnp.float64 if f64 else jnp.float32
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), t)  # noqa: E731
        jmodel = jdn.PanoDepthNet(**SMALL, compute_dtype=jdt)
        jstate = jdepth.DepthTrainState.create(apply_fn=jmodel.apply, params=cast(params), batch_stats=cast(stats),
                                               tx=optax.adam(LR))
        jstate, jloss = jdepth.make_depth_train_step()(jstate, *(jnp.asarray(b, jdt) for b in batch))
        as64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        ref_params, _ = depth_net_state_dict_from_flax(as64(jstate.params), as64(jstate.batch_stats), 18)
        ref_mu, _ = depth_net_state_dict_from_flax(as64(jstate.opt_state[0].mu), stats, 18)
        jloss = float(jloss)

    model = _port_model(params, stats, "float32").to(torch.float64 if f64 else torch.float32)
    state = tdepth.DepthTrainState(model=model, optimizer=tdepth.make_depth_optimizer(model, LR))
    state, loss = tdepth.make_depth_train_step()(state, *batch)
    assert float(loss) == pytest.approx(jloss, rel=bound["loss"])

    names = [n for n, _ in model.named_parameters()]
    grads = {n: mu.detach().double().numpy() / 0.1 for n, mu in zip(names, state.optimizer.mu)}
    ref_grads = {n: ref_mu[n].double().numpy() / 0.1 for n in names}
    gmax = max(np.abs(g).max() for g in ref_grads.values())
    for n, p in model.named_parameters():
        g, g_ref = grads[n], ref_grads[n]
        if n.endswith("attn.key.bias"):
            assert max(np.abs(g).max(), np.abs(g_ref).max()) <= 1e-6 * gmax, n
            continue
        scale = np.abs(g_ref).max()
        assert scale > 0, n
        assert np.abs(g - g_ref).max() <= bound["grad"] * scale, n
        big = np.abs(g_ref) > bound["big"] * scale
        diff = np.abs(p.detach().double().numpy() - ref_params[n].double().numpy())
        assert diff[big].max(initial=0.0) <= bound["param"], n
        assert diff.max() <= 2 * LR * 1.0001, n
    after = model.state_dict()
    for n, v in ref_params.items():
        if "running" in n:
            np.testing.assert_allclose(after[n].double().numpy(), v.double().numpy(), rtol=0, atol=bound["stats"],
                                       err_msg=n)
    assert state.step == 1 and state.optimizer.count == 1


# --------------------------------------------------------------- checkpoints


def test_port_checkpoint_reloads_bit_for_bit(tmp_path, batch):
    state = tdepth.create_depth_train_state(torch.Generator().manual_seed(0), input_hw=HW, compute_dtype="float32",
                                            device="cpu", **SMALL)
    state, _ = tdepth.make_depth_train_step()(state, *batch)
    ckpt = tdepth.save_depth_checkpoint(str(tmp_path / "depth.pt"), state)
    want = depth_net.make_depth_provider(state.model)(batch[0][1])
    got = depth_net.load_depth_provider(ckpt, device="cpu")(batch[0][1])
    assert got.shape == HW
    np.testing.assert_array_equal(got, want)


def test_salve_tpu_msgpack_loads_into_the_provider(tmp_path, batch):
    """salve_tpu's `train_depth` file: flax.serialization.to_bytes of
    {"params", "batch_stats"}, its model's defaults (embed 512, 4 blocks,
    bf16) over a ResNet-18 trunk."""
    import flax

    jmodel = jdn.PanoDepthNet(num_layers=18)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, *HW, 3))))(jax.random.PRNGKey(2))
    params, stats = _perturbed(variables, 5)
    fpath = tmp_path / "depth.msgpack"
    fpath.write_bytes(flax.serialization.to_bytes({"params": params, "batch_stats": stats}))
    ref = jdn.make_depth_provider(params, stats, num_layers=18)(batch[0][0])
    got = depth_net.load_depth_provider(str(fpath), num_layers=18, device="cpu")(batch[0][0])
    scale = np.abs(ref).max()
    err = np.abs(got - ref)
    assert err.max() <= 0.02 * scale and err.mean() <= 0.003 * scale, (err.max(), err.mean(), scale)
    with pytest.raises(ValueError, match="ResNet-18"):
        depth_net.load_depth_provider(str(fpath), num_layers=50, device="cpu")


# --------------------------------------------------------------- the CLI


def test_train_depth_cli_on_the_cpu(zind, tmp_path):
    from salve_tpu_torch.cli import train_depth

    out = train_depth.main(["--raw_dataset_dir", str(zind), "--model_save_fpath", str(tmp_path / "m" / "depth.pt"),
                            "--num_layers", "18", "--batch_size", "2", "--num_epochs", "2", "--max_steps", "3",
                            "--synthetic_rgb", "--train_buildings", ",".join(BIDS), "--eval_buildings", BIDS[1],
                            "--pano_h", "32", "--pano_w", "64", "--device", "cpu"])
    assert out["train_steps"] == 3 and np.isfinite(out["losses"]).all()
    assert (tmp_path / "m" / "depth.pt").is_file() and (tmp_path / "m" / "depth.pt.eval.json").is_file()
    assert sorted(out["eval"]) == ["abs_rel", "delta1", "log10", "n_panos", "rmse_m", "train_steps"]
    provider = depth_net.load_depth_provider(str(tmp_path / "m" / "depth.pt"), device="cpu")
    assert provider(np.zeros((32, 64, 3), np.float32)).shape == (32, 64)
