"""The port's ``Trainer`` and ``launch.train`` against the reference.

The twin of ``tests/test_io_trainer_pgm.py::test_trainer_loop_and_drift_
response``: the same reduced granite-3-2b weights (the reference's, carried
by ``convert``), the same 40 batches of the same drift corpus (numpy draws,
identical in both packages), VB steps at lr 0.05.  Tolerance: the two loss
histories within 1e-2 at every step (bf16 matmuls rounded at other places
in the two packages; measured 2.3e-3), and the reference's own drift
assertion on the port's history.  A checkpoint the port's Trainer writes
loads in ``repro.train.checkpoint`` with the same bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.tokens import TokenStream as JaxTokenStream  # noqa: E402
from repro.data.tokens import drift_corpus  # noqa: E402
from repro.nn import transformer as JT  # noqa: E402
from repro.train import checkpoint as jax_checkpoint  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

HISTORY_ATOL = 1e-2
KW = dict(optimizer="vb", lr=0.05, steps=40, n_total=2e4,
          drift_threshold=1.0, log_every=0, eval_every=0)


def _batches(stream_cls, corpus, **kw):
    for i in range(40):
        half = 0 if i < 25 else 15_000
        s = stream_cls(corpus[half:half + 15_000], 8, 64, seed=i, **kw)
        yield next(iter(s.batches(1)))


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    jcfg = jax_config("granite-3-2b").reduced()
    cfg = get_config("granite-3-2b").reduced()
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    corpus = drift_corpus(15_000, cfg.vocab, seed=1)
    jtr = JaxTrainer(jcfg, jp, JaxTrainerConfig(**KW))
    jout = jtr.fit(_batches(JaxTokenStream, corpus))
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      cfg, "cpu", trainable=True)
    path = str(tmp_path_factory.mktemp("trainer") / "ck.npz")
    ttr = Trainer(cfg, tp, TrainerConfig(device="cpu", ckpt_path=path, **KW))
    tout = ttr.fit(_batches(TokenStream, corpus, device="cpu"))
    return jtr, jout, ttr, tout, path


def test_trainer_loop_and_drift_response_match_reference(twins):
    jtr, jout, ttr, tout, _ = twins
    assert tout["steps"] == jout["steps"] == 40
    h, jh = np.asarray(ttr.history), np.asarray(jtr.history)
    np.testing.assert_allclose(h, jh, atol=HISTORY_ATOL)
    assert tout["n_drifts"] == jout["n_drifts"]
    assert np.isfinite(tout["final_loss"])
    # the reference test's assertion, on the port's history
    assert tout["n_drifts"] >= 1 or h[25:28].mean() > h[20:25].mean() + 0.05


def test_trainer_checkpoint_loads_in_the_reference(twins):
    jtr, _, ttr, _, path = twins
    back = jax_checkpoint.load(path, jtr.params)
    ref = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, back), ttr.cfg, "cpu")
    for (k, a), (k2, b) in zip(ref.named_parameters(),
                               ttr.params.named_parameters()):
        assert k == k2 and torch.equal(a, b.detach()), k


def test_trainer_drift_response_chains_a_tempered_prior():
    """On drift the VB trainer makes the posterior its prior (Eq. 3) with
    the precision tempered by ``drift_temper``; AdamW only counts."""
    from repro_torch.bayes import vb_optimizer as vb

    cfg = get_config("granite-3-2b").reduced()
    params = T.init_model(torch.Generator().manual_seed(0), cfg,
                          trainable=True)
    tr = Trainer(cfg, params, TrainerConfig(device="cpu", optimizer="vb",
                                            n_total=100.0, drift_temper=0.5))
    before = vb.posterior_prec(tr.state.vb, 100.0)
    tr._on_drift()
    assert tr.n_drifts == 1
    for k, p in tr.state.vb.prior_prec.items():
        torch.testing.assert_close(p, 0.5 * before[k])
    tr = Trainer(cfg, params, TrainerConfig(device="cpu"))
    tr._on_drift()
    assert tr.n_drifts == 1 and not hasattr(tr.state, "vb")


def test_trainer_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = get_config("granite-3-2b").reduced()
    params = T.init_model(torch.Generator().manual_seed(0), cfg,
                          trainable=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, params, TrainerConfig())


def test_trainer_refuses_frozen_parameters():
    cfg = get_config("granite-3-2b").reduced()
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="trainable=True"):
        Trainer(cfg, params, TrainerConfig(device="cpu"))


@pytest.mark.parametrize("optimizer", ["adamw", "vb"])
def test_launch_train_runs_on_the_cpu(tmp_path, capsys, optimizer):
    from repro_torch.launch import train

    path = str(tmp_path / "lm.npz")
    rc = train.main(["--arch", "granite-3-2b", "--device", "cpu", "--steps",
                     "3", "--batch", "2", "--seq", "32", "--corpus-size",
                     "4000", "--optimizer", optimizer, "--log-every", "1",
                     "--ckpt", path])
    assert rc == 0
    err = capsys.readouterr().err
    assert "[train] done" in err and err.count("[train] step=") == 3
    cfg = get_config("granite-3-2b").reduced()
    lm = convert.load_lm_checkpoint(path, cfg, "cpu")
    assert all(bool(torch.isfinite(p).all()) for p in lm.parameters())


def test_launch_train_refuses_a_mesh():
    from repro_torch.launch import train

    # a mesh needs one process a rank (torchrun's environment); the mesh
    # route itself runs in test_torch_mesh.py
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        train.main(["--arch", "granite-3-2b", "--device", "cpu",
                    "--data-shards", "2"])
