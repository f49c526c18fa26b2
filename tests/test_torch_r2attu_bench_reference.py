"""The benchmark's plain R2AttU-Net (``port_bench/families/r2attu.py``)
against the port's R2AttU-Net on the CPU in fp32: its layout against the
program's trees at the published widths (35,952,553 parameters), its FLOP
count against a hand count of one RRCNN block, and the program's train step
(``make_train_step(kernels=None)``, t = 2, per-application BN statistics)
against the reference's ``train_steps`` at base 8, 48x64, batch 2, from the
same seeded weights.

Where the two agree and how closely: the eval forward and the first train
step's loss and running statistics are well conditioned, and are held to
fp32 round-off. The gradients and the changes after three steps are not:
perturbing the inputs by 1e-7 (fp32's rounding) moves this model's
gradients by about 2% at this size (in float64; each ReLU that flips shifts
the statistics of a BN over as few as 24 elements a channel at level 4),
and RMSprop's first step moves every element by about lr / sqrt(1 − α)
whatever its gradient's size. The fp32 reference itself reads a grad_gap of
up to 3.3e-2 and an update_median_gap of up to 2.8e-2 against its float64
run on these seeds. Those comparisons are held to a few times that, which a
structural fault (a missing gate, another t, the skip and the upsampled
halves swapped) exceeds by far.
"""

import math

import pytest
import torch

from port_bench import check, inputs, reference, yardstick
from port_bench import families
from port_bench.families import r2attu
from port_bench.program import leaves_by_path, trees_for
from tpu_unet_torch.models.unet import UNetConfig, init_unet, unet_apply
from tpu_unet_torch.optim import rmsprop_init
from tpu_unet_torch.train import make_train_step

MODEL = {"arch": "r2attu", "n_channels": 3, "n_classes": 1, "bilinear": False,
         "base_channels": 8, "recur_t": 2, "recur_bn": "per_step"}
H, W, BATCH, LR = 48, 64, 2, 1e-5


def _program_config(model: dict) -> UNetConfig:
    return UNetConfig(n_channels=model["n_channels"], n_classes=model["n_classes"],
                      bilinear=False, base_channels=model["base_channels"], arch="r2attu",
                      recur_t=model["recur_t"], recur_bn=model["recur_bn"])


@pytest.fixture(scope="module", params=[1, 2**31 + 5])
def drawn(request):
    g = inputs.generator(request.param, "cpu")
    weights = r2attu.make_weights(MODEL, g, "cpu")
    images, masks = inputs.train_pool(g, 3, BATCH, H, W, "cpu")
    return weights, list(zip(images, masks))


def test_layout_is_the_programs_trees_at_full_width():
    model = {**MODEL, "base_channels": 64}
    meta_p, meta_s = init_unet(_program_config(model), None, device="meta")
    params = leaves_by_path(meta_p)
    layout = r2attu.layout(model)
    assert [p for p, _, _ in layout] == list(params)
    assert all(tuple(s) == tuple(params[p].shape) for p, s, _ in layout)
    assert sum(math.prod(s) for _, s, _ in layout) == 35_952_553
    state = families.state_by_path(meta_s)
    bn = r2attu.initial_bn_state(model, "meta")
    assert list(bn) == list(state)
    assert all(tuple(bn[k].shape) == tuple(state[k].shape) for k in state)
    assert "inc/rec1/bn2/mean" in state and "inc/rec1/bn3/mean" not in state


def test_flops_count_each_recurrent_application():
    """down1's block at 959x640 by hand: the 1x1 projection 64 -> 128, then
    2 units x (t + 1) = 6 applications of a 3x3 128 -> 128 conv, at level
    1's 320 x 479 pixels; forward, dw and dx each 2·k²·Cin·Cout a pixel."""
    model = {**MODEL, "base_channels": 64}
    px = 320 * 479
    by_hand = 2 * 64 * 128 * px + 6 * 2 * 9 * 128 * 128 * px
    convs = [c for c in r2attu.model_convs(model, 640, 959) if c["name"].startswith("down1.")]
    assert len(convs) == 7
    assert sum(yardstick._fwd(c) for c in convs) == by_hand
    # the whole step: 3 passes of every conv but the image's first, which has no dx
    first = next(c for c in r2attu.model_convs(model, 640, 959) if c["name"] == "inc.proj")
    fwd = r2attu.forward_flops(model, 640, 959)
    assert r2attu.train_flops(model, 640, 959) == pytest.approx(3 * fwd - yardstick._fwd(first))
    assert fwd == pytest.approx(2.5436e12, rel=1e-4)


def test_eval_forward_matches(drawn):
    """No batch statistics: the whole forward's structure (projections,
    recurrences, residuals, gates, ConvTranspose, padding, the concat's
    order) at fp32 round-off; 1e-5 of the logits' scale is about 100 ulps."""
    weights, batches = drawn
    bn = r2attu.initial_bn_state(MODEL, "cpu")
    cfg = _program_config(MODEL)
    params, state = trees_for(cfg, weights, bn)
    x = batches[0][0]
    prog, _ = unet_apply(params, state, x, config=cfg, train=False)
    with torch.no_grad():
        ref = r2attu.Model(MODEL)(weights, dict(bn), reference.nchw(x), train=False)
    ref = ref.permute(0, 2, 3, 1)
    assert float((prog - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _program_steps(weights, batches, steps):
    cfg = _program_config(MODEL)
    params, state = trees_for(cfg, weights, r2attu.initial_bn_state(MODEL, "cpu"))
    step = make_train_step(cfg, kernels=None, weight_decay=1e-8, momentum=0.999, grad_clip=1.0)
    trees, losses, grad = (params, state, rmsprop_init(params)), [], None
    for i, (x, y) in enumerate(batches[:steps]):
        out = step(*trees, x, y, LR)
        trees = out[:3]
        losses.append(float(out[3]))
        if i == 0:
            sq = leaves_by_path(trees[2].square_avg)
            grad = dict(zip(sq, reference.grad_norms(sq.values())))
    now = leaves_by_path(trees[0])
    change = dict(zip(now, reference.norms([now[k] - weights[k] for k in now])))
    return {"loss": losses, "grad": grad, "change": change,
            "bn_state": families.state_by_path(trees[1])}


def test_first_step_loss_and_statistics_match(drawn):
    """One step: the loss and every running mean and variance (t + 1 a
    unit). The program's BN takes one-pass fp32 sums, the reference's
    two-pass ones: 1e-5 relative is about 100 ulps."""
    weights, batches = drawn
    prog = _program_steps(weights, batches, 1)
    ref = r2attu.train_steps(MODEL, weights, r2attu.initial_bn_state(MODEL, "cpu"),
                             batches[:1], lr=LR)
    assert prog["loss"][0] == pytest.approx(ref["loss"][0], rel=1e-5)
    assert set(prog["bn_state"]) == set(ref["bn_state"])
    for k, v in ref["bn_state"].items():
        torch.testing.assert_close(prog["bn_state"][k], v, rtol=1e-5, atol=1e-6, msg=k)


def test_three_steps_match(drawn):
    """Three steps, by the benchmark's own numbers (``check.train_numbers``)
    and every running statistic, held to a few times what the fp32
    reference reads against its float64 run (module docstring)."""
    weights, batches = drawn
    prog = _program_steps(weights, batches, 3)
    ref = r2attu.train_steps(MODEL, weights, r2attu.initial_bn_state(MODEL, "cpu"), batches,
                             lr=LR)
    n = check.train_numbers(prog, ref)["numbers"]
    assert n["loss_gap"] <= 1e-2, n  # measured at most 2.3e-3
    assert n["grad_gap"] <= 0.1, n  # measured at most 2.9e-2
    assert n["update_median_gap"] <= 0.1, n  # measured at most 3.0e-2
    assert n["update_gap"] <= 0.6, n  # measured at most 0.24
    for k, v in ref["bn_state"].items():
        gap = float((prog["bn_state"][k] - v).norm() / v.norm())
        assert gap <= 0.1, (k, gap)  # measured at most 1.8e-2


def test_a_structural_fault_is_far_outside():
    """The negative control of the tolerances above: the reference with the
    skip and the upsampled halves of each concat swapped (a plausible slip)
    moves the first loss and the first statistics by far more than 1e-5."""
    g = inputs.generator(3, "cpu")
    weights = r2attu.make_weights(MODEL, g, "cpu")
    x = inputs.train_pool(g, 1, BATCH, H, W, "cpu")[0][0]

    class Swapped(r2attu.Model):
        def _rrcnn(self, x, p, path, state, train):
            if path.endswith("/conv"):
                half = x.shape[1] // 2
                x = torch.cat([x[:, half:], x[:, :half]], 1)
            return super()._rrcnn(x, p, path, state, train)

    outs = []
    for model in (r2attu.Model(MODEL), Swapped(MODEL)):
        with torch.no_grad():
            outs.append(model(weights, r2attu.initial_bn_state(MODEL, "cpu"),
                              reference.nchw(x), train=True))
    assert float((outs[0] - outs[1]).abs().max()) > 1e-2 * float(outs[0].abs().max())


def test_reference_imports_neither_the_port_nor_jax():
    import ast
    import pathlib

    src = pathlib.Path(r2attu.__file__).read_text()
    names = [a.name for node in ast.walk(ast.parse(src)) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(ast.parse(src))
              if isinstance(node, ast.ImportFrom) and node.module]
    assert not [n for n in names if n.split(".")[0] in ("tpu_unet", "tpu_unet_torch", "jax")]
