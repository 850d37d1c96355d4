"""The port's twins of ``examples/`` (``repro_torch.examples``), each run
reduced with ``--device cpu``:

  * ``quickstart`` for an arch of each family (dense, MoE, xLSTM,
    jamba's hybrid, qwen2-vl's ``embeds`` backbone, whisper's
    encoder-decoder, LeNet): its train steps' losses finite, and for a
    token LM the rollup round's metrics.  Its ``api_demo`` prints the JAX
    example's lines: the receipt's status, shard, batch, aggregate, L1
    block, gas and verify share, the account, the state root and the
    events' kinds, all equal (the node path carries no model payload, so
    the two ledgers agree bit for bit);
  * ``serve_quickstart``: the account view, the state root, the events'
    kinds and the admission metrics read over HTTP equal what the JAX
    example reads over its own wire;
  * ``serve_demo``: its tokens are ``launch.serve_model.generate``'s on
    the same model and prompts;
  * ``train_multi_pod``: ``launch.train.main``'s lines.
"""
import asyncio
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.examples import (quickstart, serve_demo, serve_quickstart,
                                  train_multi_pod)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
#: an arch of each family
ARCHS = ["qwen2-0.5b", "moonshot-v1-16b-a3b", "xlstm-1.3b",
         "jamba-1.5-large-398b", "qwen2-vl-72b", "whisper-medium", "lenet5"]


def _jax_example(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _api_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("tx receipt:", "account trainer0:",
                              "state root:"))]


@pytest.fixture(scope="module")
def jax_api_lines():
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _jax_example("quickstart").api_demo()
    lines = _api_lines(out.getvalue())
    assert len(lines) == 3
    return lines


@pytest.mark.parametrize("arch", ARCHS)
def test_quickstart_runs_every_family(arch, capsys, jax_api_lines):
    got = quickstart.main(CPU + ["--arch", arch, "--steps", "2"])
    text = capsys.readouterr().out
    assert _api_lines(text) == jax_api_lines
    assert len(got["losses"]) == 2 and np.isfinite(got["losses"]).all()
    rnd = got["round"]
    if arch in ("qwen2-vl-72b", "whisper-medium", "lenet5"):
        assert rnd is None and "rollup round" not in text
    else:
        assert np.isfinite(float(rnd["loss"]))
        assert tuple(rnd["distances"].shape) == (2,)
        assert f"digest=0x{int(rnd['digest']):08x}" in text
    assert text.rstrip().endswith("done.")


def test_api_demo_fields_equal_the_jax_examples(jax_api_lines, capsys):
    """The receipt's fields one by one, against the JAX example's line."""
    got = quickstart.api_demo("cpu")
    capsys.readouterr()
    r = got["receipt"]
    want = dict(kv.split("=") for kv in jax_api_lines[0].split()[2:])
    assert (r.status, str(r.shard), str(r.batch), str(r.aggregate_ref),
            str(r.block)) == (want["status"], want["shard"], want["batch"],
                              want["aggregate"], want["l1_block"])
    assert f"{r.gas_breakdown['batch_total']:.0f}" == want["gas"]
    assert f"{r.gas_breakdown['verify_share']:.1f}" == want["verify_share"]
    assert f"submissions={got['account'].submissions}" in jax_api_lines[1]
    assert jax_api_lines[2].startswith(f"state root: {got['state_root']} ")
    assert str(got["kinds"]) in jax_api_lines[2]


def _recording(mod):
    """Wraps ``mod.http_rpc`` to keep each method's last result."""
    real, seen = mod.http_rpc, {}

    async def rpc(host, port, method, params=None):
        status, body = await real(host, port, method, params)
        seen[method] = body.get("result")
        return status, body
    mod.http_rpc = rpc
    return seen, lambda: setattr(mod, "http_rpc", real)


def test_serve_quickstart_reads_what_the_jax_example_reads(capsys):
    jax_mod = _jax_example("serve_quickstart")
    seen, undo = _recording(jax_mod)
    try:
        asyncio.run(jax_mod.main())
    finally:
        undo()
    got = serve_quickstart.main(CPU)
    assert capsys.readouterr().out.rstrip().endswith("serving quickstart OK")
    assert got["metrics"] == seen["metrics"]
    assert got["account"] == seen["get_account"]
    assert got["state_root"] == seen["state_root"]["state_root"]
    assert got["kinds"] == sorted({e["kind"]
                                   for e in seen["events"]["events"]})


def test_serve_demo_is_generate(capsys):
    from repro_torch.configs.registry import REGISTRY, reduced_config
    from repro_torch.launch.serve_model import generate
    from repro_torch.models.model import build_model
    got = serve_demo.main(CPU + ["--tokens", "5"])
    text = capsys.readouterr().out
    assert "request gate: 4/4 clients" in text and "decode:  5 steps" in text
    cfg = reduced_config(REGISTRY["yi-6b"])
    model = build_model(cfg, "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 12))
    np.testing.assert_array_equal(
        got, generate(model, model.init_params(0), prompts, 5))


def test_serve_demo_refuses_whisper():
    with pytest.raises(ValueError, match="token-LM"):
        serve_demo.main(CPU + ["--arch", "whisper-medium"])


def test_train_multi_pod_is_the_launcher(capsys):
    from repro_torch.launch import train
    args = CPU + ["--host-mesh", "--reduced", "--rounds", "2"]
    got, want = train_multi_pod.main(args), train.main(args)
    capsys.readouterr()
    assert [(ln["round"], ln["loss"], ln["digest"], ln["mean_rep"])
            for ln in got] == [(ln["round"], ln["loss"], ln["digest"],
                                ln["mean_rep"]) for ln in want]
