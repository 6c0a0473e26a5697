"""The port's ``CheckpointStore`` (``resilience/store.py``): the JAX
package's layout and manifest, its validation and GC, and stores that
cross between the packages.

A store written by either package restores in the other: a 2-stage JAX
run's generations restore onto the port's one-stage pipeline through the
repack (the source layout split from the port's own model), and a port
run's
restore in the JAX ``CheckpointStore``. The continued runs' epoch losses
agree within rtol = atol = 3e-5 (the same f32 steps in another order and,
for the repack, another stage split).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from simple_distributed_machine_learning_tpu.data.mnist import (
    Dataset as JDataset,
)
from simple_distributed_machine_learning_tpu.models import mlp as jmlp
from simple_distributed_machine_learning_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from simple_distributed_machine_learning_tpu.parallel.pipeline import (
    Pipeline as JPipeline,
)
from simple_distributed_machine_learning_tpu.resilience import (
    CheckpointStore as JStore,
    make_elastic_trainer as jmake_elastic_trainer,
)
from simple_distributed_machine_learning_tpu.train import trainer as jtrainer
from simple_distributed_machine_learning_tpu_torch.data.mnist import Dataset
from simple_distributed_machine_learning_tpu_torch.interop import (
    params_from_numpy,
)
from simple_distributed_machine_learning_tpu_torch.models import mlp as tmlp
from simple_distributed_machine_learning_tpu_torch.parallel import (
    Pipeline,
    staging as tstaging,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    checkpoint as tck,
)
from simple_distributed_machine_learning_tpu_torch.resilience import (
    CheckpointStore,
    make_elastic_trainer,
)
from simple_distributed_machine_learning_tpu_torch.train import (
    TrainConfig,
    sgd,
)

DIMS = [12, 16, 14, 16, 10]
TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs (tiny models)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ds(cls):
    rng = np.random.RandomState(0)
    return cls(rng.randn(120, 12).astype(np.float32),
               rng.randint(0, 10, 120))


def _port_pipe(n=1):
    """The port's one-stage pipeline with the JAX package's seed-0
    weights (``n`` is the stage count asked for: the port builds one)."""
    assert n == 1
    jst = jmlp.make_mlp_stages(jax.random.key(0), DIMS, 1)[0]
    nparams = jax.tree.map(np.asarray, [s.params for s in jst])
    st, wd, od = tmlp.make_mlp_stages(0, DIMS, 1, device="cpu")
    st = [dataclasses.replace(st[0],
                              params=params_from_numpy(nparams, "cpu")[0])]
    return Pipeline(st, None, wd, od, device="cpu")


def _jax_pipe(n):
    st, wd, od = jmlp.make_mlp_stages(jax.random.key(0), DIMS, n)
    return JPipeline(st, jmake_mesh(n_stages=n, n_data=1,
                                    devices=jax.devices()[:n]), wd, od)


def _state(seed=0):
    """The port pipeline's params, with random values, and SGD momentum."""
    params = _port_pipe().init_params()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in params[0].parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    opt = sgd(0.1, 0.5)
    return params, opt.init(params)


def _cfg(epochs):
    return dict(epochs=epochs, batch_size=30, print_throughput=False)


def _losses(trainer):
    return [h["train_loss"] for h in trainer.history]


# ---------------------------------------------------------------------------
# the store on its own (tests/test_resilience.py's cases)


def test_store_save_validate_latest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=3)
    params, opt = _state()
    for step in (4, 8):
        store.save(params, opt, step, extra={"epoch": step // 4,
                                             "n_stages": 2})
    entries = store.entries()
    assert [e["step"] for e in entries] == [4, 8]
    assert all(store.validate(e) for e in entries)
    assert sorted(entries[-1]) == ["bytes", "extra", "file", "sha256",
                                   "step"]
    latest = store.latest_valid()
    assert latest["step"] == 8 and latest["extra"]["n_stages"] == 2
    assert latest["file"] == "ckpt-00000008.npz"
    assert os.path.exists(latest["path"])
    assert os.path.exists(latest["path"] + ".meta.json")


def test_store_never_selects_corrupt_checkpoint(tmp_path, capfd):
    store = CheckpointStore(str(tmp_path), keep=3)
    params, opt = _state()
    store.save(params, opt, 4, extra={"epoch": 1})
    store.save(params, opt, 8, extra={"epoch": 2})
    newest = os.path.join(str(tmp_path), store.entries()[-1]["file"])
    with open(newest, "r+b") as f:        # torn write / bad disk
        f.truncate(os.path.getsize(newest) // 2)
    latest = store.latest_valid()
    assert latest["step"] == 4
    err = capfd.readouterr().err
    assert "skipping corrupt" in err and newest in err
    with open(os.path.join(str(tmp_path), latest["file"]), "wb") as f:
        f.write(b"garbage")
    assert store.latest_valid() is None


def test_store_gc_keeps_newest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    params, opt = _state()
    for step in (1, 2, 3, 4):
        store.save(params, opt, step)
    assert [e["step"] for e in store.entries()] == [3, 4]
    files = {f for f in os.listdir(str(tmp_path)) if f.endswith(".npz")}
    assert files == {"ckpt-00000003.npz", "ckpt-00000004.npz"}
    with pytest.raises(ValueError, match="keep"):
        CheckpointStore(str(tmp_path), keep=0)


def test_store_resave_same_step_supersedes_and_gc_keeps_live_file(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    params, opt = _state()
    store.save(params, opt, 4, extra={"epoch": 1})
    store.save(params, opt, 8, extra={"epoch": 2})
    store.save(params, opt, 8, extra={"epoch": 2})   # re-run of epoch 2
    assert [e["step"] for e in store.entries()] == [4, 8]
    store.save(params, opt, 12, extra={"epoch": 3})
    assert [e["step"] for e in store.entries()] == [8, 12]
    assert store.latest_valid()["step"] == 12
    assert store.validate(store.entries()[0])


def test_store_manifest_tolerates_torn_line(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=3)
    params, opt = _state()
    store.save(params, opt, 4)
    with open(os.path.join(str(tmp_path), "MANIFEST.jsonl"), "a") as f:
        f.write('{"file": "ckpt-trunc')   # crash mid-append
    assert [e["step"] for e in store.entries()] == [4]
    assert store.latest_valid()["step"] == 4


def test_restore_latest_round_trips_bit_exact(tmp_path):
    store = CheckpointStore(str(tmp_path))
    assert store.restore_latest() is None
    params, opt = _state(3)
    store.save(params, opt, 6, extra={"epoch": 2})
    pipe = _port_pipe()
    st = store.restore_latest(pipe=pipe, opt_treedef_like=opt)
    assert st["step"] == 6 and st["entry"]["file"] == "ckpt-00000006.npz"
    for a, b in zip(params[0].parameters(), st["params"][0].parameters()):
        assert torch.equal(a, b)
    for a, b in zip(opt, st["opt_state"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# stores that cross between the packages


def test_jax_store_and_port_store_agree_on_layout(tmp_path):
    """One state saved through each package's store: the same files, the
    same manifest keys and extra, the same arrays inside."""
    params, opt = _state()
    ours = CheckpointStore(str(tmp_path / "port"))
    ours.save(params, opt, 4, extra={"epoch": 1, "n_stages": 1})
    packed = np.load(os.path.join(str(tmp_path / "port"),
                                  "ckpt-00000004.npz"))
    theirs = JStore(str(tmp_path / "jax"))
    theirs.save(packed["params"], [packed["opt_0"]], 4,
                extra={"epoch": 1, "n_stages": 1})
    a, b = ours.entries()[0], theirs.entries()[0]
    assert sorted(a) == sorted(b)
    assert (a["file"], a["step"], a["extra"]) == (b["file"], b["step"],
                                                  b["extra"])
    with np.load(ours.latest_valid()["path"]) as x, \
            np.load(theirs.latest_valid()["path"]) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            if k != "_meta_json":
                np.testing.assert_array_equal(x[k], y[k])
        assert (json.loads(bytes(x["_meta_json"]).decode())
                == json.loads(bytes(y["_meta_json"]).decode()))


def test_two_stage_jax_store_restores_onto_the_port(tmp_path):
    """Epoch 1 on two stages in the JAX package's elastic trainer; epochs
    2-3 on the port's one card from the store it wrote, through the
    repack — as the JAX package's own 2 -> 1 restore continues."""
    jds, ds = _ds(JDataset), _ds(Dataset)
    jstore = JStore(str(tmp_path), keep=4)
    jmake_elastic_trainer(_jax_pipe, 2, jstore, jds, jds,
                          jtrainer.TrainConfig(**_cfg(1))).fit()
    assert jstore.latest_valid()["extra"]["n_stages"] == 2
    ours = make_elastic_trainer(_port_pipe, 1, CheckpointStore(str(tmp_path),
                                                               keep=4),
                                ds, ds, TrainConfig(**_cfg(3)))
    assert (ours._step_count, ours.start_epoch) == (4, 2)
    ours.fit()
    # the JAX reference continuation (its own repack 2 -> 1), from a
    # fresh 2-stage epoch 1 in a store of its own: the first one now holds
    # the port's generations
    ref_dir = str(tmp_path / "ref")
    jstore2 = JStore(ref_dir, keep=4)
    jmake_elastic_trainer(_jax_pipe, 2, jstore2, jds, jds,
                          jtrainer.TrainConfig(**_cfg(1))).fit()
    ref = jmake_elastic_trainer(_jax_pipe, 1, jstore2, jds, jds,
                                jtrainer.TrainConfig(**_cfg(3)))
    ref.fit()
    assert [h["epoch"] for h in ours.history] == [2, 3]
    np.testing.assert_allclose(_losses(ours), _losses(ref), **TOL)
    assert CheckpointStore(str(tmp_path)).latest_valid()["extra"][
        "n_stages"] == 1


def test_port_store_restores_in_the_jax_store(tmp_path):
    """Epoch 1 through the port's elastic trainer; epochs 2-3 in the JAX
    package's from the port's store — as the port's own resume
    continues."""
    jds, ds = _ds(JDataset), _ds(Dataset)
    store = CheckpointStore(str(tmp_path / "a"), keep=4)
    make_elastic_trainer(_port_pipe, 1, store, ds, ds,
                         TrainConfig(**_cfg(1))).fit()
    assert JStore(store.dir).latest_valid()["step"] == 4
    theirs = jmake_elastic_trainer(_jax_pipe, 1, JStore(store.dir), jds, jds,
                                   jtrainer.TrainConfig(**_cfg(3)))
    assert (theirs._step_count, theirs.start_epoch) == (4, 2)
    theirs.fit()
    store_b = CheckpointStore(str(tmp_path / "b"), keep=4)
    make_elastic_trainer(_port_pipe, 1, store_b, ds, ds,
                         TrainConfig(**_cfg(1))).fit()
    ours = make_elastic_trainer(_port_pipe, 1, store_b, ds, ds,
                                TrainConfig(**_cfg(3)))
    ours.fit()
    np.testing.assert_allclose(_losses(theirs), _losses(ours), **TOL)


@pytest.mark.parametrize("model,n", [("mlp", 2), ("mlp", 4), ("gpt", 2),
                                     ("gpt", 3)])
def test_split_layout_is_the_multi_stage_builds(model, n):
    """The layout a restore repacks from — the one-stage model split into
    ``n`` contiguous stages — is what the ``n``-stage builds give, in the
    port's builders and the JAX package's."""
    from simple_distributed_machine_learning_tpu.models import gpt as jgpt
    from simple_distributed_machine_learning_tpu_torch.models import (
        gpt as tgpt,
    )
    if model == "mlp":
        build = (lambda k: tmlp.make_mlp_stages(0, DIMS, k, device="cpu"))
        jst = jmlp.make_mlp_stages(jax.random.key(0), DIMS, n)[0]
    else:
        cfg = dict(vocab=32, seq_len=8, d_model=16, n_heads=2, n_layers=3)
        build = (lambda k: tgpt.make_gpt_stages(0, tgpt.GPTConfig(**cfg), k,
                                                device="cpu"))
        jst = jgpt.make_gpt_stages(jax.random.key(0), jgpt.GPTConfig(**cfg),
                                   n)[0]
    one = [tstaging.stage_meta(s.params) for s in build(1)[0]]
    split = tck.split_layout(one, n)
    assert split == [tstaging.stage_meta(s.params) for s in build(n)[0]]
    assert [m.shapes for m in split] == [
        tuple(tuple(np.shape(a)) for a in jax.tree.leaves(s.params))
        for s in jst]
