"""The port's Gumbel training, split GAN step and gradient accumulation
against the JAX package's, on the CPU.

``configs/fake_vitvq_tiny.yaml`` builds both sides (32 px, two-layer
ViTs, the StyleGAN discriminator at 32 px, random LPIPS), all in f32; the
JAX parameters of the autoencoder, the discriminator and LPIPS are carried
into the port. The Gumbel tokenizer is that model with the quantizer of
``configs/imagenet_vitvq_gumbel_base.yaml`` (the same parameter tree, so
the JAX module is the VQ one cloned with ``quantizer_type="gumbel"``).
Both sides draw the same Gumbel noise: the test replaces
``jax.random.gumbel`` and the port's ``quantizers.gumbel_noise`` with
queues of the same seeded numpy arrays, taken in call order; the JAX side
takes them through an ordered ``io_callback`` at run time, so one jitted
step draws new noise at each call. Torch runs on one thread here: the
tests share the CPU with other test processes.
"""
import copy
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import io_callback

from enhancing_tpu.train.optim import make_ae_optimizer as jax_make_optimizer
from enhancing_tpu.train.steps import GANTrainState as JaxGANTrainState
from enhancing_tpu.train.steps import \
    make_vitvq_train_step as jax_make_train_step
from enhancing_tpu.train.steps import \
    make_vitvq_train_steps_split as jax_make_split_steps
from enhancing_tpu.train.trainer import Trainer as JaxTrainer
from enhancing_tpu.utils.config import \
    initialize_from_config as jax_initialize_from_config
from enhancing_tpu.utils.config import load_config as jax_load_config
from enhancing_tpu_torch.compat import (load_lpips_from_jax,
                                        load_style_discriminator_from_jax,
                                        load_vitvq_from_jax)
from enhancing_tpu_torch.models.stage1 import quantizers
from enhancing_tpu_torch.train import trainer as trainer_module
from enhancing_tpu_torch.train.steps import key_generator
from enhancing_tpu_torch.train import (ExponentialDecayScheduler,
                                       GANTrainState, Trainer,
                                       make_ae_optimizer,
                                       make_vitvq_train_step,
                                       make_vitvq_train_steps_split)
from enhancing_tpu_torch.utils.config import (initialize_from_config,
                                              load_config)

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "configs" / "fake_vitvq_tiny.yaml"
GUMBEL = REPO / "configs" / "imagenet_vitvq_gumbel_base.yaml"
LR = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_side():
    jm = jax_initialize_from_config(jax_load_config(TINY).model)
    return jm, {"ae": _np_tree(jm.params),
                "disc": _np_tree(jm.loss.disc_init_params),
                "lpips": _np_tree(jm.loss.lpips_params)}


def _gumbel_model_config():
    """The tiny model as the shipped Gumbel config's ViTVQGumbel: its
    target, quantizer temp_init and temperature scheduler."""
    cfg = load_config(TINY).model.to_dict()
    shipped = load_config(GUMBEL).model.to_dict()
    cfg["target"] = shipped["target"]
    cfg["params"]["quantizer"]["temp_init"] = \
        shipped["params"]["quantizer"]["temp_init"]
    cfg["params"]["temperature_scheduler"] = \
        shipped["params"]["temperature_scheduler"]
    return cfg


def _port_model(trees, gumbel=False):
    cfg = _gumbel_model_config() if gumbel else load_config(TINY).model
    model = initialize_from_config(cfg, device="cpu")
    load_vitvq_from_jax(model, trees["ae"])
    load_style_discriminator_from_jax(model.loss.discriminator,
                                      trees["disc"])
    load_lpips_from_jax(model.loss.perceptual, trees["lpips"])
    return model


def _batches(n):
    rng = np.random.default_rng(0)
    low = rng.random((n, 4, 4, 4, 3), dtype=np.float32)
    return list(np.repeat(np.repeat(low, 8, axis=2), 8, axis=3))


class Batches:
    """A data module of fixed training batches and no validation split."""

    datasets: dict = {}

    def __init__(self, images) -> None:
        self.images = images

    def setup(self) -> None:
        pass

    def train_dataloader(self):
        return [{"image": x} for x in self.images]


def _jax_state(trees, ae_tx, disc_tx):
    ae, disc = _jnp_tree(trees["ae"]), _jnp_tree(trees["disc"])
    return JaxGANTrainState(
        step=jnp.zeros((), jnp.int32), ae_params=ae, ae_opt=ae_tx.init(ae),
        disc_params=disc, disc_opt=disc_tx.init(disc),
        lpips_params=_jnp_tree(trees["lpips"]))


def _port_state(model, accumulate=1):
    return GANTrainState(
        0, make_ae_optimizer(model.module.parameters(), LR,
                             accumulate=accumulate),
        make_ae_optimizer(model.loss.discriminator.parameters(), LR,
                          accumulate=accumulate))


def _logs_match(tlog, jlog):
    assert set(tlog) == set(jlog)
    for k in jlog:
        # f32 losses through the ViT, LPIPS and the discriminator, another
        # summation order on each side (tests/test_torch_train.py's limit)
        np.testing.assert_allclose(float(tlog[k]), float(jlog[k]),
                                   rtol=2e-4, atol=1e-6, err_msg=k)


def _agree(got, want, cos_min, norm_rtol, label):
    """Cosine and norm ratio of two tensors, flattened, in fp64."""
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    ng, nw = np.linalg.norm(g), np.linalg.norm(w)
    if nw == 0.0:
        assert ng == 0.0, label
        return
    assert abs(ng / nw - 1.0) <= norm_rtol, (label, ng / nw)
    assert g @ w / (ng * nw) >= cos_min, (label, g @ w / (ng * nw))


def _params_match(model, tstate, before, jax_state, updates):
    """The autoencoder's and the discriminator's AdamW first moments and
    parameter movements after ``updates`` updates, against JAX's, tensor
    by tensor:

    - the first moment (the running mean of the gradients, before Adam's
      normalisation): cosine >= 0.9999 and norms within 1e-3;
    - the movement, in units of lr: every entry within 2 lr an update,
      cosine >= 0.99 and norms within 1e-2. AdamW moves an entry by about
      lr * m / (sqrt(v) + 1e-8), which turns the f32 noise of gradients
      below its eps, or of ones that nearly cancel between updates, into
      differences of up to 2 lr at a few entries; and an autoencoder step
      that moved such entries differently hands the D phase another
      reconstruction. Measured (single-threaded torch) over these tests:
      moments at worst cosine 0.9999914, norms 1.2e-4 apart; movements
      at worst cosine 0.9961 (a D bias of 512 entries), norms 9.5e-4."""
    pairs = ((model.module, before.module, jax_state.ae_params,
              jax_state.ae_opt, tstate.ae_opt, load_vitvq_from_jax),
             (model.loss.discriminator, before.loss.discriminator,
              jax_state.disc_params, jax_state.disc_opt, tstate.disc_opt,
              load_style_discriminator_from_jax))
    for after, start, jax_new, jax_opt, opt, load in pairs:
        ref, ref_mu = copy.deepcopy(start), copy.deepcopy(start)
        load(ref, _np_tree(jax_new))
        load(ref_mu, _np_tree(optax.tree_utils.tree_get(jax_opt, "mu")))
        b, r = dict(start.named_parameters()), dict(ref.named_parameters())
        mu = dict(ref_mu.named_parameters())
        adam = opt.opt.state
        for name, p in after.named_parameters():
            _agree(adam[p]["exp_avg"].numpy(), mu[name].detach().numpy(),
                   0.9999, 1e-3, f"{name} first moment")
            got = ((p - b[name]) / LR).detach().numpy()
            want = ((r[name] - b[name]) / LR).detach().numpy()
            assert np.all(np.abs(got - want) <= 2.0 * updates + 1e-3), name
            _agree(got, want, 0.99, 1e-2, f"{name} movement")


# -- Gumbel training ---------------------------------------------------------

class NoiseQueue:
    """Seeded numpy Gumbel arrays in call order: call i of a queue gets
    ``default_rng((seed, i)).gumbel(shape)``."""

    def __init__(self, seed: int) -> None:
        self.seed, self.calls = seed, 0

    def next(self, shape) -> np.ndarray:
        out = np.random.default_rng((self.seed, self.calls)).gumbel(
            size=tuple(shape)).astype(np.float32)
        self.calls += 1
        return out


def test_gumbel_noise_is_finite_and_gumbel_distributed():
    """The port's draw: u in [tiny, 1), so -log(-log(u)) is finite even
    where the uniform draw is 0; mean and variance of Gumbel(0, 1) (Euler's
    constant, pi^2 / 6) within five standard errors."""
    g = quantizers.gumbel_noise((4096, 64), torch.Generator().manual_seed(0),
                                torch.device("cpu"), torch.float32)
    assert bool(torch.isfinite(g).all())
    n = g.numel()
    assert abs(float(g.mean()) - 0.5772157) < 5 * (np.pi ** 2 / 6 / n) ** 0.5
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 5 * 2.3 / n ** 0.5
    tiny = torch.finfo(torch.float32).tiny
    assert float(-torch.log(-torch.log(torch.tensor(tiny)))) > -5.0


@pytest.fixture(scope="module")
def gumbel_steps(jax_side):
    """Two Gumbel train steps on each side from the same weights, batches
    and noise (temperatures 0.9, then 0.8): the JAX logs and states after
    each step, the port's logs and the port model's copies after each."""
    jm, trees = jax_side
    module = jm.module.clone(quantizer_type="gumbel")
    jmodel = SimpleNamespace(module=module, constants=jm.constants)
    xs, temps = _batches(2), (0.9, 0.8)
    mp = pytest.MonkeyPatch()
    jq, tq = NoiseQueue(5), NoiseQueue(5)
    mp.setattr(jax.random, "gumbel", lambda key, shape, dtype=jnp.float32,
               **_: io_callback(lambda: jq.next(shape),
                                jax.ShapeDtypeStruct(shape, dtype),
                                ordered=True))
    mp.setattr(quantizers, "gumbel_noise",
               lambda shape, generator, device, dtype: torch.from_numpy(
                   tq.next(shape)).to(device, dtype))
    try:
        ae_tx, disc_tx = jax_make_optimizer(LR), jax_make_optimizer(LR)
        state = _jax_state(trees, ae_tx, disc_tx)
        step = jax_make_train_step(jmodel, jm.loss, ae_tx, disc_tx)
        jax_out = []
        for x, temp in zip(xs, temps):
            state, jlog = step(state, jnp.asarray(x), jax.random.PRNGKey(0),
                               jnp.float32(temp))
            jax_out.append((jlog, _np_tree(state)))

        model = _port_model(trees, gumbel=True)
        before = copy.deepcopy(model)
        tstate = _port_state(model)
        step = make_vitvq_train_step(model, model.loss)
        port_out = []
        for i, (x, temp) in enumerate(zip(xs, temps)):
            tlog = step(tstate, torch.from_numpy(x), rng=i, temp=temp)
            # the model and its optimizers, copied together
            model_now, state_now = copy.deepcopy((model, tstate))
            port_out.append((tlog, model_now, state_now))
        assert jq.calls == tq.calls == 4  # the AE and D forward a step
    finally:
        mp.undo()
    assert tstate.step == 2
    return jax_out, port_out, before


@pytest.mark.parametrize("n", [1, 2])
def test_gumbel_train_step_logs_match_jax(gumbel_steps, n):
    jax_out, port_out, _ = gumbel_steps
    _logs_match(port_out[n - 1][0], jax_out[n - 1][0])


@pytest.mark.parametrize("n", [1, 2])
def test_gumbel_train_step_parameters_match_jax(gumbel_steps, n):
    jax_out, port_out, before = gumbel_steps
    _params_match(*port_out[n - 1][1:], before, jax_out[n - 1][1], n)


def test_gumbel_temperatures_match_the_jax_trainer(monkeypatch):
    """The port's Trainer passes the temperature of the shipped schedule
    (ExponentialDecayScheduler(1.0, 0.0625, 1, 1e-5)) to each of 5 steps
    (the step replaced by a recorder: the Trainer's plumbing is under
    test), equal to JAX Trainer._gumbel_temp at each global step (the JAX
    one is fp32), with a distinct key each step; the schedule itself
    against JAX's out to its floor."""
    model = initialize_from_config(_gumbel_model_config(), device="cpu")
    seen = []

    def recorder(model, loss, reuse_xrec=False):
        def step(state, x, do_r1=False, rng=None, temp=None):
            seen.append((rng, temp))
            state.step += 1
            return {}
        return step

    monkeypatch.setattr(trainer_module, "make_vitvq_train_step", recorder)
    trainer = Trainer(max_steps=5, base_lr=LR, log_every=10)
    trainer.fit(model, Batches(_batches(5)))
    assert trainer.final_state.step == 5
    keys, temps = zip(*seen)
    assert len(set(keys)) == 5 and trainer.last_temp == temps[-1]

    sched_cfg = jax_load_config(GUMBEL).model.params.temperature_scheduler
    jt = JaxTrainer(max_steps=5)
    jmodel = SimpleNamespace(
        temperature_scheduler=jax_initialize_from_config(sched_cfg),
        module=SimpleNamespace(quantizer={}))
    want = []
    for n in range(5):
        jt.global_step = n
        want.append(jt._gumbel_temp(jmodel))
    np.testing.assert_allclose(temps, want, rtol=1e-7)
    assert temps[0] == 1.0 and temps[4] < temps[1] < 1.0

    port = ExponentialDecayScheduler(**load_config(GUMBEL).model.params
                                     .temperature_scheduler.params)
    for n in (0, 1, 7, 1000, 277258, 277259, 10 ** 6):
        np.testing.assert_allclose(port(n), float(jmodel
                                   .temperature_scheduler(n)), rtol=1e-6)


def test_gumbel_split_and_fused_trainers_agree(jax_side, monkeypatch):
    """The fused and split Trainers build one step, the split step's two
    phases (``make_vitvq_train_step``), and hand it the same keys and
    temperatures from one seed; reuse_xrec only adds its flag; another
    seed gives other keys at the same temperatures. One key gives the
    Gumbel forward the same draw on every call, another key another."""
    _, trees = jax_side
    model = _port_model(trees, gumbel=True)
    seen = {}
    for label, kw in (("fused", {}), ("split", dict(split_gan_step=True)),
                      ("reuse", dict(reuse_xrec=True)),
                      ("seed", dict(seed=1))):
        calls = seen[label] = []

        def recorder(model, loss, reuse_xrec=False, calls=calls):
            calls.append(reuse_xrec)

            def step(state, x, do_r1=False, rng=None, temp=None):
                calls.append((rng, temp))
                state.step += 1
                return {}
            return step

        monkeypatch.setattr(trainer_module, "make_vitvq_train_step",
                            recorder)
        Trainer(max_steps=3, base_lr=LR, log_every=10, **kw).fit(
            model, Batches(_batches(3)))
    assert seen["fused"][0] is False and len(seen["fused"]) == 4
    assert seen["split"] == seen["fused"]
    assert seen["reuse"] == [True, *seen["fused"][1:]]
    keys, temps = zip(*seen["fused"][1:])
    other_keys, other_temps = zip(*seen["seed"][1:])
    assert other_temps == temps and not set(other_keys) & set(keys)

    x = torch.from_numpy(_batches(1)[0])
    with torch.no_grad():
        draws = [model.module.forward_training(
            x, 0.9, False, key_generator(key, x.device))[0]
            for key in (keys[0], keys[0], keys[1])]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])


# -- the split GAN step --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_split_logs(jax_side):
    """JAX's split steps, two steps each way from the same state: reuse ->
    the logs of ae_step then disc_step on its reconstruction, fresh ->
    those of disc_step on a fresh one, and the states after. One pair of
    jitted steps serves both: reuse_xrec's ae_step is the plain one that
    also returns its reconstruction, which the fresh way drops."""
    jm, trees = jax_side
    ae_tx, disc_tx = jax_make_optimizer(LR), jax_make_optimizer(LR)
    j_ae, j_d = jax_make_split_steps(jm, jm.loss, ae_tx, disc_tx,
                                     reuse_xrec=True)
    key, temp = jax.random.PRNGKey(0), jnp.float32(1.0)
    out = {}
    for reuse_xrec in (False, True):
        state, jlogs = _jax_state(trees, ae_tx, disc_tx), []
        for x in _batches(2):
            state, log, xrec = j_ae(state, jnp.asarray(x), key, temp)
            state, d_log = j_d(state, jnp.asarray(x), key, temp,
                               xrec=xrec if reuse_xrec else None)
            jlogs.append({**log, **d_log})
        out[reuse_xrec] = jlogs, state
    return out


@pytest.mark.parametrize("reuse_xrec", [False, True], ids=["fresh", "reuse"])
def test_split_steps_match_jax(jax_side, jax_split_logs, reuse_xrec):
    """make_vitvq_train_steps_split on the VQ tokenizer, two steps of
    ae_step then disc_step (with reuse_xrec, D on ae_step's
    reconstruction): every log value of both steps and the AE and D
    parameters afterwards against JAX's; disc_step alone advances step."""
    _, trees = jax_side
    jlogs, state = jax_split_logs[reuse_xrec]
    model = _port_model(trees)
    before = copy.deepcopy(model)
    tstate = _port_state(model)
    ae_step, disc_step = make_vitvq_train_steps_split(
        model, model.loss, reuse_xrec=reuse_xrec)
    for i, (x, jlog) in enumerate(zip(_batches(2), jlogs)):
        out = ae_step(tstate, torch.from_numpy(x))
        log, xrec = out if reuse_xrec else (out, None)
        assert tstate.step == i
        log.update(disc_step(tstate, torch.from_numpy(x), xrec=xrec))
        _logs_match(log, jlog)
    assert tstate.step == 2
    _params_match(model, tstate, before, state, 2)


def test_split_step_refuses_the_adaptive_weight(jax_side):
    _, trees = jax_side
    model = _port_model(trees)
    model.loss.use_adaptive_adv = True
    with pytest.raises(NotImplementedError, match="fused train step"):
        make_vitvq_train_steps_split(model, model.loss)


# -- gradient accumulation ------------------------------------------------------

def test_accumulated_steps_match_jax_multisteps(jax_side):
    """accumulate_grad_batches=2: four micro-steps of the fused VQ step on
    four batches against JAX's step over optax.MultiSteps(every_k=2): the
    logs of each micro-step and both sides' parameters after the fourth;
    on the port the AE and D parameters are bit-equal after micro-steps 1
    and 3 (nothing moves), and move after 2 and 4."""
    jm, trees = jax_side
    xs = _batches(4)
    ae_tx = jax_make_optimizer(LR, None, accumulate=2)
    disc_tx = jax_make_optimizer(LR, None, accumulate=2)
    state = _jax_state(trees, ae_tx, disc_tx)
    jstep = jax_make_train_step(jm, jm.loss, ae_tx, disc_tx)
    jlogs = []
    for x in xs:
        state, log = jstep(state, jnp.asarray(x), jax.random.PRNGKey(0),
                           jnp.float32(1.0))
        jlogs.append(log)

    model = _port_model(trees)
    before = copy.deepcopy(model)
    tstate = _port_state(model, accumulate=2)
    assert tstate.ae_opt.every_k == 2
    step = make_vitvq_train_step(model, model.loss)

    def snapshot():
        return [p.detach().clone() for p in
                [*model.module.parameters(),
                 *model.loss.discriminator.parameters()]]

    last = snapshot()
    for i, (x, jlog) in enumerate(zip(xs, jlogs)):
        _logs_match(step(tstate, torch.from_numpy(x)), jlog)
        now = snapshot()
        same = all(torch.equal(a, b) for a, b in zip(last, now))
        assert same == (i % 2 == 0), i
        last = now
    assert tstate.step == 4
    assert tstate.ae_opt.sched.last_epoch == 2  # it counts updates
    _params_match(model, tstate, before, state, 2)


# -- the Trainer's options -------------------------------------------------------

def test_trainer_option_checks():
    """reuse_xrec implies the split step; accumulation takes k >= 1."""
    trainer = Trainer(reuse_xrec=True)
    assert trainer.split_gan_step and trainer.reuse_xrec
    with pytest.raises(ValueError, match="at least 1"):
        Trainer(accumulate_grad_batches=0)


def test_chip_smoke_holds_the_gumbel_and_convergence_configs():
    """chip_smoke.py's phases 16 and 17 train the shipped Gumbel model
    block and the convergence config as load_config builds them."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.GUMBEL_VITVQ_BASE == load_config(GUMBEL).model.to_dict()
    assert smoke.CONVERGENCE_VITVQ_BASE == load_config(
        REPO / "configs" / "convergence_vitvq_base.yaml").to_dict()
