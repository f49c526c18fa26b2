"""The port's train CLI with ``--wandb --profile DIR --debug-nans`` on the
CPU (base 8, a stub ``wandb``): the flags log, trace and check as the JAX
CLI's do, without moving the run's losses; the profiler wraps the
out-of-memory retry; the flags still ported nowhere stay refused; and
``tools/profile_step.py``'s trace parser and kernel groups."""

import json
import sys
import types

import numpy as np
import pytest
import torch

import tpu_unet_torch.models.unet as t_unet
import tpu_unet_torch.train as t_train
from tpu_unet_torch import train_cli
from tpu_unet_torch.checkpoint import save_checkpoint
from tpu_unet_torch.data import make_synthetic_carvana
from tpu_unet_torch.models.unet import UNetConfig, init_unet
from tpu_unet_torch.tools import profile_step
from tpu_unet_torch.utils.debug_nans import DebugNans

FLAGS = ["--wandb", "--profile", "PROFILE", "--debug-nans"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs")
    make_synthetic_carvana(root / "data", n=10, h=32, w=48, seed=0)
    save_checkpoint(root / "init.npz", *init_unet(UNetConfig(3, 1, False, 8),
                                                  np.random.default_rng(0)))
    return root


@pytest.fixture
def cli(data_root, tmp_path, monkeypatch):
    """(argv, stub logs, DebugNans modes made by the CLI)."""
    monkeypatch.setattr(t_unet, "UNetConfig", lambda **kw: UNetConfig(**kw, base_channels=8))
    logs, modes = [], []
    fake = types.ModuleType("wandb")
    fake.init = lambda **k: types.SimpleNamespace(
        config=types.SimpleNamespace(update=lambda *a, **k: None), log=logs.append)
    fake.Histogram = lambda v: ("hist", int(np.asarray(v).size))
    fake.Image = lambda v: ("img", np.asarray(v).shape)
    monkeypatch.setitem(sys.modules, "wandb", fake)

    def recording_mode():
        modes.append(DebugNans())
        return modes[-1]

    monkeypatch.setattr(train_cli, "DebugNans", recording_mode)
    argv = ["--device", "cpu", "-e", "1", "-b", "2", "-l", "1e-4", "-s", "1.0", "-v", "20",
            "--val-per-epoch", "2", "--data-dir", str(data_root / "data"), "--load",
            str(data_root / "init.npz"), "--checkpoint-dir", str(tmp_path / "ck")]
    return argv, logs, modes


def _with_trace(flags, trace_dir):
    return [str(trace_dir) if f == "PROFILE" else f for f in flags]


def test_train_cli_observability_flags(cli, tmp_path):
    argv, logs, modes = cli
    trace_dir = tmp_path / "trace"
    _, _, history = train_cli.main(argv + _with_trace(FLAGS, trace_dir))
    # --wandb: each step's loss, and the panel at each validation.
    assert [d["train loss"] for d in logs if "train loss" in d] == history["train_loss"]
    val_logs = [d for d in logs if "validation Dice" in d]
    assert len(history["train_loss"]) == 4 and len(val_logs) == 2
    assert all(any(k.startswith("Gradients/") for k in v) for v in val_logs)
    # --profile: one Chrome trace of the run, the CPU ops of its steps in it.
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and "convolution" in e.get("name", "") for e in events)
    # --debug-nans: the mode checked every op of the run, the backward's too.
    assert len(modes) == 1 and any("backward" in k for k in modes[0].checked)
    # None of the three moves the run.
    _, _, plain = train_cli.main(argv)
    assert plain["train_loss"] == history["train_loss"]
    assert plain["val_dice"] == history["val_dice"]


def test_profile_wraps_the_oom_retry(cli, tmp_path, monkeypatch):
    argv, _, modes = cli
    seen = []

    def fake_train_model(params, bn_state, config, **kw):
        seen.append((kw["remat"], torch.autograd.profiler._is_profiler_enabled, bool(modes)))
        if len(seen) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return params, bn_state, {"train_loss": [], "val_dice": [], "lr": []}

    monkeypatch.setattr(t_train, "train_model", fake_train_model)
    train_cli.main(argv + _with_trace(FLAGS, tmp_path / "trace"))
    assert seen == [(False, True, True), (True, True, True)]
    assert list((tmp_path / "trace").glob("*.pt.trace.json"))


def _refusal(flag: list) -> str | None:
    """The message that refuses ``flag`` before any training: JAX's
    refusals of --tensor-parallel without --data-parallel and of the ported
    --zero and --multihost (with the rendezvous flags that need
    --multihost). None for --spatial-parallel without --data-parallel,
    which JAX trains as the plain run (no mesh), and for
    --pipeline-parallel, which trains as the --accum-steps run."""
    if flag[0] in ("--spatial-parallel", "--pipeline-parallel"):
        return None
    if flag[0] == "--tensor-parallel":
        return "--tensor-parallel requires --data-parallel"
    if "--kernels" in flag:
        return "--zero requires the library route"
    if flag[0] == "--multihost":
        return "multi-host training requires --data-parallel"
    if flag[0] in ("--coordinator", "--num-processes", "--process-id"):
        return f"{flag[0]} applies with --multihost"
    return "--zero requires --data-parallel"


@pytest.mark.parametrize("flag", [
    ["--data-parallel", "--zero", "--kernels", "cuda"], ["--multihost", "--num-processes", "2"],
    ["--coordinator", "h:1"], ["--num-processes", "2"],
    ["--process-id", "0"], ["--spatial-parallel", "2"], ["--tensor-parallel", "2"],
    ["--pipeline-parallel", "2"], ["--zero"],
])
def test_other_flags_stay_refused(cli, tmp_path, flag):
    argv, logs, modes = cli
    match = _refusal(flag)
    if match is None:
        # Trains as the plain run: the history bitwise the run without it;
        # the GPipe stages (both on the CPU) as the --accum-steps S run, by
        # JAX's tolerances for that pair (tests/test_pipeline.py's e2e).
        got = train_cli.main(argv + flag)[2]
        if flag[0] == "--pipeline-parallel":
            want = train_cli.main(argv + ["--accum-steps", flag[1]])[2]
            np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-3,
                                       atol=1e-4)
            np.testing.assert_allclose(got["val_dice"], want["val_dice"], atol=1e-3)
        else:
            assert got == train_cli.main(argv)[2]
        assert got["train_loss"] and got["val_dice"]
        return
    with pytest.raises(SystemExit, match=match):
        train_cli.main(argv + _with_trace(FLAGS, tmp_path / "trace") + flag)
    assert not logs and not modes and not (tmp_path / "trace").exists()


def _trace(tmp_path, kernels):
    tmp_path.mkdir(parents=True, exist_ok=True)
    events = [{"ph": "X", "cat": "kernel", "name": name, "dur": dur, "ts": i}
              for i, (name, dur) in enumerate(kernels)]
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 50.0, "ts": 0})
    (tmp_path / "host_1.1.pt.trace.json").write_text(json.dumps({"traceEvents": events}))


def test_parse_trace_groups_the_kernels(tmp_path):
    _trace(tmp_path, [
        ("void tc_conv_kernel<Cfg0, ProLoad, StatsEpi>(Params)", 300.0),
        ("void tc_conv_kernel<Cfg0, ProLoad, StatsEpi>(Params)", 100.0),
        ("void tc_conv_kernel<DxCfg, DzLoad, RoundEpi>(Params)", 250.0),
        ("void tc_dw_kernel<64>(DwParams)", 200.0),
        ("void tc_conv_kernel<F32Cfg, DzLoadF32, Tf32x3Op>(Params)", 20.0),
        ("sm90_xmma_fprop_implicit_gemm", 80.0),
        ("void at::native::vectorized_elementwise_kernel<4>", 50.0),
        ("some_other_kernel", 1.0),
    ])
    out = profile_step.main(["--parse", str(tmp_path)])
    groups = out["groups_ms"]
    assert groups["tc_conv_kernel (conv3x3_fwd, tensor cores)"] == pytest.approx(0.4)
    assert groups["tc_conv_kernel<DzLoad> (conv3x3_dx, tensor cores)"] == pytest.approx(0.25)
    assert groups["tc_conv_kernel<DzLoadF32> (conv3x3_dx fp32, 3xTF32)"] == pytest.approx(0.02)
    assert groups["tc_dw_kernel (conv3x3_dw, tensor cores)"] == pytest.approx(0.2)
    assert groups["cuDNN / cutlass (ConvTranspose, 1x1)"] == pytest.approx(0.08)
    assert groups["elementwise / copies"] == pytest.approx(0.05)
    assert groups["other"] == pytest.approx(0.001)
    assert out["kernel_ms"] == pytest.approx(1.001)


def test_parse_trace_refuses_a_trace_without_kernels(cli, tmp_path):
    with pytest.raises(SystemExit, match="no Chrome trace"):
        profile_step.parse_trace(tmp_path)
    argv, _, _ = cli
    train_cli.main(argv + ["--profile", str(tmp_path / "cpu")])
    with pytest.raises(SystemExit, match="holds no CUDA kernel"):
        profile_step.parse_trace(tmp_path / "cpu")


def test_profile_step_run_needs_a_gpu():
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            profile_step.run(batch=1, size=16)
