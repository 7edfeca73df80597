"""PyTorch port vs the JAX package: the breakage models
(models/breakage_model.py) and `cli fit-model`, and the MLP's sharded train
step at dp 2 and at tp 2 on two gloo ranks. Inputs come from numpy seeds and
the JAX package's parameters carry across unchanged.

Tolerances. forward and loss_fn: atol 1e-5, rtol 1e-5. Both frameworks
round the hidden activations to bf16 before each dot; their float32
activations differ in the last bits (summation order, tanh), so now and then
one activation rounds to the neighbouring bf16 value (under 1% of rows
here). So each layer is compared on the same input: a hidden activation
the two round apart must be one bf16 ulp away, every row's output is held
at 1e-5 of JAX's read-out of the port's activations, and every row whose
bf16 activations all equal JAX's own at 1e-5 of JAX's forward. Gradients: one bf16 ulp, rtol 2^-7
elementwise (the weights' gradients are rounded to bf16). One Adam step:
parameters within atol 1e-5."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from genomeassembler_dev_tpu.core.querytable import load_default_query_table  # noqa: E402
from genomeassembler_dev_tpu.models import breakage_model as jbm  # noqa: E402
from genomeassembler_dev_tpu_torch import cli  # noqa: E402
from genomeassembler_dev_tpu_torch.core.querytable import QueryTable  # noqa: E402
from genomeassembler_dev_tpu_torch.models import breakage_model as tbm  # noqa: E402
from genomeassembler_dev_tpu_torch.parallel import sharding  # noqa: E402
from genomeassembler_dev_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from test_torch_spawn import run_ranks  # noqa: E402

ATOL = RTOL = 1e-5
BF16_ULP = 2.0**-7
HIDDEN = 64
BATCH = 512


@pytest.fixture(scope="module")
def jtable():
    return load_default_query_table()


@pytest.fixture(scope="module")
def ttable(jtable):
    return QueryTable.from_numpy(jtable.probs, "cpu")


def jax_params(seed=0, hidden=HIDDEN, bias_seed=1):
    """JAX's initial parameters, with nonzero biases so every term counts."""
    p = {k: np.asarray(v) for k, v in jbm.init_params(jax.random.key(seed), hidden=hidden).items()}
    rng = np.random.default_rng(bias_seed)
    for name in ("b1", "b2", "b3"):
        p[name] = (0.1 * rng.standard_normal(p[name].shape)).astype(np.float32)
    return p


def batch(jtable, seed=2, n=BATCH):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 65536, n).astype(np.int32)
    return codes, np.log(jtable.probs[8][codes].astype(np.float32))


def as_jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def jax_dot(x, w):
    return jnp.dot(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)


def jax_layers(p):
    """JAX's forward (models/breakage_model.py) as its three layers."""
    return (lambda x: np.asarray(jax.nn.gelu(jax_dot(x, p["w1"]) + p["b1"])),
            lambda h1: np.asarray(jax.nn.gelu(jax_dot(h1, p["w2"]) + p["b2"])),
            lambda h2: np.asarray((jax_dot(h2, p["w3"]) + p["b3"])[:, 0]))


def bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def assert_forward_close(model, p, codes, atol=ATOL, rtol=RTOL):
    """The port's forward against JAX's on the same parameters, layer by
    layer (see the module docstring). Returns the port's output."""
    feats = tbm.one_hot_octamer(torch.from_numpy(codes))
    with torch.no_grad():
        h1 = model.layer1(feats).numpy()
        h2 = model.layer2(torch.from_numpy(h1)).numpy()
        got = model.readout(torch.from_numpy(h2)).numpy()
    j1, j2, j3 = jax_layers(p)
    x = np.asarray(jbm.one_hot_octamer(jnp.asarray(codes)))
    want = np.asarray(jbm.forward(as_jax(p), jnp.asarray(x)))
    jh1 = j1(x)
    apart = np.zeros(len(codes), bool)  # rows whose bf16 activations differ
    for mine, theirs, own in ((h1, jh1, jh1), (h2, j2(h1), j2(jh1))):
        a, b = bf16(mine), bf16(theirs)  # each layer on the same input
        diff = a != b
        mag = np.maximum(np.abs(a), np.abs(b))[diff]
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
        assert (np.abs(a - b)[diff] <= ulp).all(), "activations more than one bf16 ulp apart"
        apart |= (a != bf16(own)).any(axis=1)
    assert apart.mean() < 0.01, apart.sum()
    np.testing.assert_allclose(got, j3(h2), atol=atol, rtol=rtol)
    np.testing.assert_allclose(got[~apart], want[~apart], atol=atol, rtol=rtol)
    return got


def assert_grads_close(got: dict, want: dict):
    for name in tbm.PARAM_NAMES:
        np.testing.assert_allclose(got[name], want[name], rtol=BF16_ULP, atol=0, err_msg=name)


def test_one_hot_features():
    f = tbm.one_hot_octamer(torch.tensor([0, 65535, 1234], dtype=torch.int32)).numpy()
    want = np.asarray(jbm.one_hot_octamer(jnp.asarray([0, 65535, 1234], jnp.int32)))
    np.testing.assert_array_equal(f, want)
    assert f[0].reshape(8, 4)[:, 0].sum() == 8 and f[1].reshape(8, 4)[:, 3].sum() == 8


def test_table_model_lookup(jtable, ttable):
    codes = np.array([0, 1, 2, 65535], np.int32)
    got = tbm.TableModel(ttable).log_prob(8, torch.from_numpy(codes)).numpy()
    want = np.asarray(jbm.TableModel(jtable).log_prob(8, jnp.asarray(codes)))
    np.testing.assert_array_equal(got, want)


def test_forward_and_loss_vs_jax(jtable):
    p = jax_params()
    codes, target = batch(jtable)
    model = tbm.params_from_numpy(p, "cpu")
    assert_forward_close(model, p, codes)
    loss = float(tbm.loss_fn(model, torch.from_numpy(codes), torch.from_numpy(target)).detach())
    jloss = float(jbm.loss_fn(as_jax(p), jnp.asarray(codes), jnp.asarray(target)))
    np.testing.assert_allclose(loss, jloss, atol=ATOL, rtol=RTOL)


def test_grads_vs_jax_within_one_bf16_ulp(jtable):
    p = jax_params()
    codes, target = batch(jtable)
    model = tbm.params_from_numpy(p, "cpu")
    tbm.loss_fn(model, torch.from_numpy(codes), torch.from_numpy(target)).backward()
    jg = jax.grad(jbm.loss_fn)(as_jax(p), jnp.asarray(codes), jnp.asarray(target))
    got = {n: getattr(model, n).grad.numpy() for n in tbm.PARAM_NAMES}
    want = {n: np.asarray(jg[n]) for n in tbm.PARAM_NAMES}
    assert_grads_close(got, want)
    # the weights' gradients carry JAX's bf16 rounding: bf16 values exactly
    for name in ("w1", "w2", "w3"):
        rounded = tbm.round_bf16(torch.from_numpy(got[name])).numpy()
        np.testing.assert_array_equal(rounded, got[name])


def test_bf16_dot_backward_rounds():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    out = tbm.bf16_dot(x, w)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  (tbm.round_bf16(x) @ tbm.round_bf16(w)).detach().numpy())
    out.backward(g)
    with torch.no_grad():
        xb, wb = tbm.round_bf16(x), tbm.round_bf16(w)
        np.testing.assert_array_equal(x.grad.numpy(), tbm.round_bf16(g @ wb.T).numpy())
        np.testing.assert_array_equal(w.grad.numpy(), tbm.round_bf16(xb.T @ g).numpy())


def test_one_adam_step_vs_optax(jtable):
    p = jax_params()
    codes, target = batch(jtable)
    opt = optax.adam(1e-3)
    jp, _, jloss = jbm.make_train_step(opt)(as_jax(p), opt.init(as_jax(p)),
                                            jnp.asarray(codes), jnp.asarray(target))
    model = tbm.params_from_numpy(p, "cpu")
    loss = tbm.make_train_step(tbm.adam(model, 1e-3))(model, torch.from_numpy(codes),
                                                      torch.from_numpy(target))
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=RTOL)
    for name in tbm.PARAM_NAMES:
        np.testing.assert_allclose(getattr(model, name).detach().numpy(), np.asarray(jp[name]),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_init_params_scales():
    gen = torch.Generator()
    gen.manual_seed(0)
    model = tbm.init_params(gen, k=8, hidden=256, device="cpu")
    assert tuple(model.w1.shape) == (32, 256) and tuple(model.w3.shape) == (256, 1)
    assert all(float(getattr(model, b).detach().abs().max()) == 0 for b in ("b1", "b2", "b3"))
    np.testing.assert_allclose(float(model.w1.detach().std()), (2 / 32) ** 0.5, rtol=0.05)
    np.testing.assert_allclose(float(model.w2.detach().std()), (2 / 256) ** 0.5, rtol=0.05)


def test_fit_reduces_loss(jtable, ttable):
    """JAX's settings (tests/test_models.py::test_fit_reduces_loss)."""
    params, losses = tbm.fit_to_table(ttable, steps=300, batch=2048, hidden=128, lr=3e-3)
    assert losses[-1] < losses[0] * 0.5
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 65536, size=4096).astype(np.int32)
    with torch.no_grad():
        pred = tbm.forward(params, tbm.one_hot_octamer(torch.from_numpy(codes))).numpy()
    corr = np.corrcoef(pred, np.log(jtable.probs[8][codes]))[0, 1]
    assert corr > 0.3, corr


def test_jax_checkpoint_loads_into_the_port_and_back(tmp_path):
    p = {k: jnp.asarray(v) for k, v in jax_params(seed=3, hidden=32).items()}
    codes = np.random.default_rng(4).integers(0, 65536, 256).astype(np.int32)
    jbm.save_params(str(tmp_path / "jax.npz"), p)
    model = tbm.load_params(str(tmp_path / "jax.npz"), "cpu")
    for name in tbm.PARAM_NAMES:
        np.testing.assert_array_equal(getattr(model, name).detach().numpy(), np.asarray(p[name]))
    tbm.save_params(str(tmp_path / "port" / "model.npz"), model)
    back = jbm.load_params(str(tmp_path / "port" / "model.npz"))
    assert set(back) == set(tbm.PARAM_NAMES)
    feats = jbm.one_hot_octamer(jnp.asarray(codes))
    np.testing.assert_array_equal(np.asarray(jbm.forward(back, feats)),
                                  np.asarray(jbm.forward(p, feats)))
    got = assert_forward_close(model, {k: np.asarray(v) for k, v in p.items()}, codes)
    with torch.no_grad():
        again = tbm.forward(tbm.load_params(str(tmp_path / "port" / "model.npz"), "cpu"),
                            tbm.one_hot_octamer(torch.from_numpy(codes))).numpy()
    np.testing.assert_array_equal(again, got)


def test_cli_fit_model_cpu(tmp_path, capsys):
    out = str(tmp_path / "m.npz")
    cli.main(["fit-model", "--device", "cpu", "--steps", "30", "--hidden", "32",
              "--out", out])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["checkpoint"] == out and rec["loss_last"] < rec["loss_first"]
    with np.load(out) as d:
        assert sorted(d.files) == sorted(tbm.PARAM_NAMES)
        assert d["w1"].shape == (32, 32) and d["w3"].shape == (32, 1)


# -- the sharded train step on two gloo ranks ---------------------------------

MESHES = {"dp 2": (2, 1, 1), "tp 2": (1, 1, 2)}
STEPS = 3


def _train_case(rank, p, batches):
    out = {}
    for name, shape in MESHES.items():
        mesh = make_mesh(*shape, device_type="cpu")
        local = sharding.shard_params(mesh, tbm.params_from_numpy(p, "cpu"))
        step = sharding.make_sharded_train_step(mesh, tbm.adam(local, 1e-3))
        losses, grads = [], None
        for codes, target in batches:
            losses.append(float(step(local, torch.from_numpy(codes), torch.from_numpy(target))))
            if grads is None:  # the first step's gradients, whole
                grads = {}
                for n, dim in sharding.TP_DIMS.items():
                    g = getattr(local, n).grad
                    grads[n] = (g if dim is None else
                                sharding.gather(g, mesh, "tp", dim)).numpy()
        out[name] = {"losses": losses, "grads": grads,
                     "params": tbm.params_to_numpy(sharding.unshard_params(mesh, local))}
    return out


def test_sharded_train_step_two_ranks(jtable, tmp_path):
    p = jax_params()
    batches = [batch(jtable, seed=10 + i, n=256) for i in range(STEPS)]
    ranks = run_ranks(_train_case, 2, tmp_path, p, batches)
    opt = optax.adam(1e-3)
    jstep = jbm.make_train_step(opt)
    params, state = as_jax(p), opt.init(as_jax(p))
    jgrads = jax.grad(jbm.loss_fn)(params, jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]))
    jlosses = []
    for codes, target in batches:
        params, state, loss = jstep(params, state, jnp.asarray(codes), jnp.asarray(target))
        jlosses.append(float(loss))
    for got in ranks:
        for name in MESHES:
            np.testing.assert_allclose(got[name]["losses"], jlosses, rtol=RTOL, atol=0,
                                       err_msg=name)
            assert_grads_close(got[name]["grads"], {n: np.asarray(jgrads[n]) for n in jgrads})
            for n in tbm.PARAM_NAMES:
                np.testing.assert_allclose(got[name]["params"][n], np.asarray(params[n]),
                                           atol=ATOL, rtol=0, err_msg=f"{name} {n}")
