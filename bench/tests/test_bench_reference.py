"""The plain references against the port at the reduced sizes, in float32
on the CPU (the port there runs its plain kernels): the logits, the loss
and every gradient leaf; the Mamba-2 scan's chunked form against the
recurrence step by step; the float8 control's rounding."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_cell
from yardstick import plain, weights


def f32_cell(config):
    cell = tiny_cell(config, "train-4x2048")
    cell.config["model"] = dict(cell.model, dtype="float32")
    return cell


def port_model(m):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as model_lib

    return model_lib.build(ModelConfig(**m), "cpu")


@pytest.mark.parametrize("config", ["granite-3-2b", "zamba2-2.7b"])
def test_reference_logits_and_loss_match_the_port(config):
    cell = f32_cell(config)
    m = cell.model
    flat = weights.make(m, 11, torch.device("cpu"))
    tokens = torch.randint(0, m["vocab_size"], (2, 37),
                           generator=torch.Generator().manual_seed(1))
    model = port_model(m)
    with torch.no_grad():
        want = model.forward(weights.nest(flat), {"tokens": tokens})
        got = cell.reference.logits(flat, tokens, m)
        last = cell.reference.logits(flat, tokens, m, last_only=True)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(last[:, 0], got[:, -1])
    with torch.no_grad():
        loss = model.train_loss(weights.nest(flat), {"tokens": tokens})
    assert float(plain.next_token_loss(got, tokens)) == pytest.approx(
        float(loss), rel=1e-5)


@pytest.mark.parametrize("config", ["granite-3-2b", "zamba2-2.7b"])
def test_reference_gradients_match_the_port(config):
    cell = f32_cell(config)
    m = cell.model
    flat = weights.make(m, 12, torch.device("cpu"))
    tokens = torch.randint(0, m["vocab_size"], (2, 33),
                           generator=torch.Generator().manual_seed(2))
    ours = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss = plain.next_token_loss(
        cell.reference.logits(ours, tokens, m, remat=True), tokens)
    g_ref = dict(zip(ours, torch.autograd.grad(loss, list(ours.values()))))
    theirs = {k: v.clone().requires_grad_() for k, v in flat.items()}
    port_loss = port_model(m).train_loss(weights.nest(theirs),
                                         {"tokens": tokens})
    g_port = dict(zip(theirs, torch.autograd.grad(port_loss,
                                                  list(theirs.values()))))
    for k in flat:
        err = (g_ref[k] - g_port[k]).norm() / g_port[k].norm().clamp(min=1e-12)
        assert err < 1e-4, (k, float(err))


def test_ssd_scan_is_the_recurrence():
    g = torch.Generator().manual_seed(3)
    B, T, H, P, N = 2, 150, 3, 4, 5
    dt = torch.rand(B, T, H, generator=g, dtype=torch.float64) * 0.5
    x = torch.randn(B, T, H, P, generator=g, dtype=torch.float64)
    b = torch.randn(B, T, N, generator=g, dtype=torch.float64)
    c = torch.randn(B, T, N, generator=g, dtype=torch.float64)
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 4
    h = torch.zeros(B, H, P, N, dtype=torch.float64)
    ys = []
    for t in range(T):
        h = torch.exp(dt[:, t] * A)[..., None, None] * h + \
            (dt[:, t, :, None] * x[:, t])[..., None] * b[:, t, None, None]
        ys.append((h * c[:, t, None, None]).sum(-1))
    want = torch.stack(ys, 1)
    torch.testing.assert_close(plain.ssd_scan(dt, x, b, c, A, chunk=64), want)
    torch.testing.assert_close(plain.ssd_scan(dt, x, b, c, A, chunk=16), want)


def test_the_controls_rounding_keeps_three_mantissa_bits_both_ways():
    t = torch.tensor([1.0, 1.0625, 1.125, 300.0, -448.0], requires_grad=True)
    q = plain.low(t, True)
    # scale = 448 / 448: 1.0625 lies halfway between 1 and 1.125
    assert q.tolist()[0] == 1.0 and q.tolist()[2] == 1.125
    assert q.tolist()[3] in (288.0, 320.0) and q.tolist()[4] == -448.0
    q.backward(torch.tensor([1.0, 1.0625, 3.0, 0.5, -3.0]))
    # the gradient rounded too, at its own scale (3 / 448)
    assert t.grad.tolist()[1] != 1.0625 and t.grad.tolist()[2] == 3.0
    assert plain.low(t, False) is t
