"""The port's training launcher (``python -m repro_torch.launch.train``)
on the CPU: reduced rounds, resume equal to an uninterrupted run, the
one-card mesh, the data pipeline and the synthetic data beside the JAX
package's."""
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.data import pipeline, synthetic
from repro_torch.launch import mesh, train

torch.set_num_threads(1)


def test_reduced_rounds_run_and_learn():
    lines = train.main(["--reduced", "--device", "cpu", "--rounds", "3",
                        "--host-mesh"])
    assert [ln["round"] for ln in lines] == [0, 1, 2]
    assert all(np.isfinite(ln["loss"]) and 0 <= ln["digest"] < 2 ** 32
               for ln in lines)
    assert len({ln["digest"] for ln in lines}) == 3


def test_resume_equals_an_uninterrupted_run(tmp_path):
    # the one-card mesh: the production mesh needs a process group of its
    # size (test_multi_pod_and_wide_meshes_are_refused)
    one = ["--reduced", "--device", "cpu", "--host-mesh"]
    full = train.main(one + ["--rounds", "4"])
    first = train.main(one + ["--rounds", "2", "--ckpt-dir", str(tmp_path)])
    rest = train.main(one + ["--rounds", "4", "--ckpt-dir", str(tmp_path),
                             "--resume"])
    key = [(ln["round"], ln["loss"], ln["digest"], ln["mean_rep"])
           for ln in (first + rest)]
    assert key == [(ln["round"], ln["loss"], ln["digest"], ln["mean_rep"])
                   for ln in full]


def test_multi_pod_and_wide_meshes_are_refused():
    # without a process group of their size the production and wide
    # meshes raise, naming the world size they found; under a faked group
    # of 256 or 512 ranks they build (the dry run's meshes)
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world
    with pytest.raises(RuntimeError, match="found no process group"):
        train.main(["--reduced", "--device", "cpu", "--multi-pod"])
    with pytest.raises(RuntimeError, match="found no process group"):
        train.main(["--reduced", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="found no process group"):
        mesh.make_train_mesh(data=2, device="cpu")
    m = mesh.make_host_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    try:
        fake_world(256)
        with pytest.raises(RuntimeError, match="world size 256"):
            mesh.make_production_mesh(multi_pod=True, device="cpu")
        with pytest.raises(RuntimeError, match="world size 256"):
            mesh.make_train_mesh(data=2, device="cpu")
        assert mesh.mesh_shape(mesh.make_production_mesh(device="cpu")) \
            == {"data": 16, "model": 16}
        fake_world(512)
        m = mesh.make_production_mesh(multi_pod=True, device="cpu")
        assert mesh.mesh_shape(m) == {"pod": 2, "data": 16, "model": 16}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("ranks", [256, 512])
def test_launcher_runs_the_mesh_round_on_the_production_mesh(ranks,
                                                             monkeypatch):
    # inside a (faked) group of the production mesh's size the launcher
    # runs the mesh round, T = data x pod trainers, each rank's stacks one
    # trainer row; the fake backend's collectives move no data, so the
    # round's numbers are this rank's alone and only its shapes are held
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world
    argv = ["--reduced", "--device", "cpu", "--rounds", "1"] + (
        ["--multi-pod"] if ranks == 512 else [])
    real, seen = train.MeshRound.step, []

    def step(self, params_T, opt_T, scores, toks):
        seen.append((self.spec.n_trainers, toks.shape[0],
                     {k: (v.shape[0], v.to_local().shape[0])
                      for k, v in params_T.items()}, scores.shape[0]))
        return real(self, params_T, opt_T, scores, toks)
    monkeypatch.setattr(train.MeshRound, "step", step)
    try:
        fake_world(ranks)
        lines = train.main(argv)
    finally:
        dist.destroy_process_group()
    T = ranks // 16
    assert [ln["round"] for ln in lines] == [0] and len(seen) == 1
    n, block, rows, scores = seen[0]
    assert n == block == scores == T
    assert set(rows.values()) == {(T, 1)}


def test_synthetic_data_match_jax():
    a = next(synthetic.token_batches(500, 3, 7, seed=4))
    b = next(jsyn.token_batches(500, 3, 7, seed=4))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], b[k])
    for x, y in zip(synthetic.make_mnist_like(64, seed=2),
                    jsyn.make_mnist_like(64, seed=2)):
        np.testing.assert_array_equal(x, y)


def test_prefetcher_and_client_batches():
    from repro.data.pipeline import client_batch_fn as jax_client_batch_fn
    it = synthetic.token_batches(100, 2, 5, seed=1)
    want = [next(synthetic.token_batches(100, 2, 5, seed=1))]
    pf = pipeline.Prefetcher(it, depth=2, device="cpu")
    got = next(pf)
    pf.close()
    assert isinstance(got["tokens"], torch.Tensor)
    np.testing.assert_array_equal(got["tokens"].numpy(), want[0]["tokens"])
    xs, ys = synthetic.make_mnist_like(40, seed=0)
    parts = [np.arange(0, 20), np.arange(20, 40)]
    fn = pipeline.client_batch_fn(xs, ys, parts, 5)
    jfn = jax_client_batch_fn(xs, ys, parts, 5)
    for c, r in ((0, 0), (1, 3)):
        np.testing.assert_array_equal(fn(c, r)["labels"], jfn(c, r)["labels"])


def _recording(module, monkeypatch, seen):
    """Patches ``module.build_fl_round`` so that every round's batches are
    kept, as numpy, in ``seen`` before the round runs."""
    real = module.build_fl_round

    def build(*a, **kw):
        fl_round = real(*a, **kw)

        def recorded(params_T, opt_T, scores, batches):
            seen.append({k: np.array(v.cpu() if isinstance(v, torch.Tensor)
                                     else v) for k, v in batches.items()})
            return fl_round(params_T, opt_T, scores, batches)
        return recorded
    monkeypatch.setattr(module, "build_fl_round", build)


def test_batches_equal_the_jax_launchers(monkeypatch):
    import jax

    from repro.launch import train as jtrain
    argv = ["--reduced", "--host-mesh", "--rounds", "4"]
    mine, theirs = [], []
    _recording(train, monkeypatch, mine)
    _recording(jtrain, monkeypatch, theirs)
    train.main(argv + ["--device", "cpu"])
    with jax.disable_jit():
        jtrain.main(argv)
    assert len(mine) == len(theirs) == 4
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for key in a:
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])
