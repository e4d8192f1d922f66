"""The forward's train mode and the chain without the forward, on the CPU:
the two plain versions (`fused_field_train_plain`, `fused_field_chain_plain`)
compose to the one-function plain operands exactly; the autograd Function
keeps the train mode's result for its backward and runs no second forward;
without a gradient it runs the serving forward; the operand-ownership table
and the ReLU mask layout. The kernels themselves are compared with these
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from genefaceplusplus_tpu_torch.ops import fused_field as ff


def _field(n, seed):
    """Seeded inputs at realistic ranges (Fourier phases, ReLUs, tanh)."""
    rs = np.random.RandomState(seed)
    mats = {k: (rs.randn(*s) * 0.1).astype(np.float32) for k, (s, _) in ff.FIELD_SHAPES.items()}
    for k in ("pos_B", "amb_B"):
        mats[k][3:] = 0.0
        mats[k][:3] *= 30.0
    mats["amb_w3"] *= 5.0
    w = ff.FieldWeights(**{k: torch.from_numpy(v).to(ff.FIELD_SHAPES[k][1]) for k, v in mats.items()})
    xyz = torch.from_numpy(rs.uniform(-1, 1, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rs.randn(n, 3).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    ab, cb = (torch.from_numpy((rs.randn(128) * 0.3).astype(np.float32)) for _ in range(2))
    gs, gr, ga = (torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in ((n,), (n, 3), (n, 3)))
    return xyz, d, ab, cb, w, gs, gr, ga


def _operands_one_function(xyz, dirs, amb_bias, col_bias, w, g_sigma, g_rgb, g_amb, amb_dim=3):
    """The chain's plain operands as one function that recomputes the
    forward, before the forward's train mode took the activations over
    (kept here as the reference)."""
    relu, _r = torch.relu, ff._r
    pos_B, amb_w1, amb_w2, amb_w3, amb_B, sig_w1, sig_w2, sig_w3, col_w1, col_w2 = [t.float() for t in w]
    xyz, dirs = xyz.float(), dirs.float()
    proj = ff.project(xyz, pos_B[:3])
    sin_p, cos_p = ff.fast_sin(proj), ff.fast_cos(proj)
    pos_feat = _r(torch.cat([sin_p, cos_p], dim=-1))
    a1 = relu(pos_feat @ amb_w1[:256] + amb_bias)
    a1b = _r(a1)
    a2 = relu(a1b @ amb_w2)
    a2b = _r(a2)
    amb_pos = ff.fast_tanh(a2b @ amb_w3[:, :amb_dim])
    aproj = ff.project(amb_pos, amb_B[:amb_dim])
    sin_a, cos_a = ff.fast_sin(aproj), ff.fast_cos(aproj)
    amb_feat = _r(torch.cat([sin_a, cos_a], dim=-1))
    s1 = relu(pos_feat @ sig_w1[:256] + amb_feat @ sig_w1[256:384])
    s1b = _r(s1)
    s2 = relu(s1b @ sig_w2)
    s2b = _r(s2)
    sig_out = s2b @ sig_w3[:, :129]
    sig_logit = sig_out[:, 0]
    sigma = torch.exp(torch.clamp(sig_logit, -15.0, 15.0))
    geo = _r(sig_out[:, 1:129])
    sh = _r(ff._sh16(dirs))
    c1 = relu(sh @ col_w1[:16] + geo @ col_w1[16:144] + col_bias)
    c1b = _r(c1)
    rgb = 1.0 / (1.0 + torch.exp(-(c1b @ col_w2[:, :3])))

    g_rgb_logit = _r(g_rgb.float() * rgb * (1.0 - rgb))
    g_c1 = _r((g_rgb_logit @ col_w2[:, :3].t()) * (c1 > 0.0))
    g_geo = g_c1 @ col_w1[16:144].t()
    in_range = (sig_logit > -15.0) & (sig_logit < 15.0)
    g_sig0 = torch.where(in_range, g_sigma.float() * sigma, torch.zeros_like(sigma))
    g_sig_out = _r(torch.cat([g_sig0[:, None], g_geo], dim=-1))
    g_s2 = _r((g_sig_out @ sig_w3[:, :129].t()) * (s2 > 0.0))
    g_s1 = _r((g_s2 @ sig_w2.t()) * (s1 > 0.0))
    g_pos_feat_s = g_s1 @ sig_w1[:256].t()
    g_amb_feat = g_s1 @ sig_w1[256:384].t()
    g_aproj = _r(g_amb_feat[:, :64] * cos_a - g_amb_feat[:, 64:] * sin_a)
    g_amb_pos = g_aproj @ _r(amb_B[:amb_dim]).t() + g_amb.float()
    g_amb_logit = _r(g_amb_pos * (1.0 - amb_pos * amb_pos))
    g_a2 = _r((g_amb_logit @ amb_w3[:, :amb_dim].t()) * (a2 > 0.0))
    g_a1 = _r((g_a2 @ amb_w2.t()) * (a1 > 0.0))
    g_pos_feat = g_pos_feat_s + g_a1 @ amb_w1[:256].t()
    g_proj = _r(g_pos_feat[:, :128] * cos_p - g_pos_feat[:, 128:] * sin_p)

    def cols(x, n):
        return F.pad(x, (0, n - x.shape[1]))

    return {
        "x0": pos_feat[:, 0:64], "x1": pos_feat[:, 64:128], "x2": pos_feat[:, 128:192],
        "x3": pos_feat[:, 192:256], "xa": amb_feat, "a1": a1b, "a2": a2b, "s1": s1b, "s2": s2b,
        "c1": c1b, "gc1a": g_c1[:, :64], "gc1b": g_c1[:, 64:], "gaproj": g_aproj, "gproj": g_proj,
        "gs1": g_s1, "ga1": g_a1, "ga2": g_a2, "gs2": g_s2,
        "gsig": cols(torch.cat([g_sig_out[:, 1:129], g_sig_out[:, :1]], dim=-1), 136),
        "g": torch.cat([geo, sh], dim=-1), "grgb": cols(g_rgb_logit, 8), "gamb": cols(g_amb_logit, 8),
        "apos": cols(_r(amb_pos), 8), "xyzb": cols(_r(xyz), 8),
    }


@pytest.mark.parametrize("n", [1, 63, 65, 300])
def test_split_plain_versions_compose_to_the_one_function_operands(n):
    """fused_field_train_plain then fused_field_chain_plain give every
    operand of the one-function plain chain bit for bit, each from the
    kernel that OPERAND_WRITERS names; the train mode's outputs are the
    serving plain version's bit for bit, as the kernel's train mode is the
    serving mode's."""
    args = _field(n, 40 + n)
    fwd = ff.fused_field_train_plain(*args[:5])
    grads = ff.fused_field_chain_plain(args[0], fwd, args[4], *args[5:])
    assert tuple(fwd.ops) == ff.OPERAND_WRITERS["fused_field"]
    assert tuple(grads) == ff.OPERAND_WRITERS["fused_field_bwd"]
    ref = _operands_one_function(*args)
    composed = ff.fused_field_bwd_operands_plain(*args)
    assert list(composed) == [name for name, _ in ff.WGRAD_OPERANDS]
    for name, _ in ff.WGRAD_OPERANDS:
        got = fwd.ops[name] if name in fwd.ops else grads[name]
        assert torch.equal(got, ref[name]), name
        assert torch.equal(composed[name], ref[name]), name
    for a, b in zip(fwd[:3], ff.fused_field_plain(*args[:5])):
        assert torch.equal(a, b)
    assert fwd.relu.shape == (n, len(ff.RELU_LAYERS), 128) and fwd.relu.dtype == torch.bool
    assert fwd.gate.shape == (n,) and fwd.gate.dtype == torch.bool
    # the masks are the activations' (relu(x) > 0 is bf16(relu(x)) > 0 at these ranges)
    for i, name in enumerate(ff.RELU_LAYERS):
        assert torch.equal(fwd.relu[:, i], fwd.ops[name] > 0), name


def test_chain_plain_reads_the_gate():
    """The sigma gradient goes through the forward's gate alone: a closed
    gate zeroes the g_sigma_logit row of gsig and nothing else moves it."""
    args = _field(50, 3)
    fwd = ff.fused_field_train_plain(*args[:5])
    assert fwd.gate.all()  # these logits lie inside (-15, 15)
    opened = ff.fused_field_chain_plain(args[0], fwd, args[4], *args[5:])
    shut = fwd._replace(gate=torch.zeros_like(fwd.gate))
    closed = ff.fused_field_chain_plain(args[0], shut, args[4], *args[5:])
    assert not closed["gsig"][:, 128].any()
    assert torch.equal(opened["gsig"][:, 128], ff._r(args[5] * fwd.sigma))
    torch.testing.assert_close(opened["grgb"], closed["grgb"], rtol=0, atol=0)


def test_backward_from_the_train_mode_equals_the_plain_backward():
    args = _field(130, 8)
    fwd = ff.fused_field_forward_train(*args[:5])  # CPU tensors: the plain version
    for a, b in zip(ff.backward_from_train(args[0], fwd, args[4], *args[5:]), ff.fused_field_backward(*args)):
        assert torch.equal(a, b)


def _autograd_inputs(n, seed):
    xyz, d, _, _, w, gs, gr, ga = _field(n, seed)
    rs = np.random.RandomState(seed + 1)
    cond = torch.from_numpy((rs.randn(1, 64) * 0.5).astype(np.float32)).requires_grad_()
    ind = torch.from_numpy((rs.randn(4) * 0.5).astype(np.float32)).requires_grad_()
    w = ff.FieldWeights(*[t.clone().requires_grad_() for t in w])
    return xyz, d, cond, ind, w, (gs, gr, ga)


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(ff, name)

    def counted(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(ff, name, counted)
    return calls


def test_backward_reuses_the_forward(monkeypatch):
    """fused_field_train's forward runs the train mode once; its backward
    runs the chain and the weight gradients on what the forward kept, and
    no forward (serving, train mode or the one-function operands). A
    second backward on the same graph gives the same gradients; the
    gradients equal fused_field_backward's from the same inputs."""
    xyz, d, cond, ind, w, (gs, gr, ga) = _autograd_inputs(100, 5)
    calls = []
    for name in ("fused_field_plain", "fused_field_train_plain", "fused_field_bwd_operands_plain",
                 "fused_field_chain_plain", "fused_field_wgrad_plain"):
        calls_of = _counting(monkeypatch, name)
        calls.append(calls_of)
    s, c, a = ff.fused_field_train(xyz, d, cond, ind, w)
    forward_calls = [x for cs in calls for x in cs]
    assert forward_calls == ["fused_field_train_plain"]
    loss = (s * gs).sum() + (c * gr).sum() + (a * ga).sum()
    first = torch.autograd.grad(loss, [cond, ind, *w], retain_graph=True)
    second = torch.autograd.grad(loss, [cond, ind, *w])
    backward_calls = [x for cs in calls for x in cs][1:]
    assert sorted(backward_calls) == sorted(["fused_field_chain_plain", "fused_field_wgrad_plain"] * 2)
    for g1, g2 in zip(first, second):
        assert torch.equal(g1, g2)
    ab, cb = ff.bias_rows(cond.detach(), ind.detach(), ff.FieldWeights(*[t.detach() for t in w]))
    blocks = ff.fused_field_backward(xyz, d, ab, cb, ff.FieldWeights(*[t.detach() for t in w]), gs, gr, ga)
    assert torch.equal(first[2 + 0], blocks[0])  # pos_B
    assert torch.equal(first[2 + 2].float(), blocks[3].to(torch.bfloat16).float())  # amb_w2, cast to bf16


def test_without_a_gradient_the_forward_writes_no_operands(monkeypatch):
    """Under no_grad, and when nothing requires a gradient, fused_field_train
    runs the serving forward (no operands, masks or gate are made), with
    the train mode's outputs."""
    xyz, d, cond, ind, w, _ = _autograd_inputs(70, 9)
    with torch.no_grad():
        want = ff.fused_field_train(xyz, d, cond, ind, w)
    train = _counting(monkeypatch, "fused_field_train_plain")
    serve = _counting(monkeypatch, "fused_field_plain")
    with torch.no_grad():
        got = ff.fused_field_train(xyz, d, cond, ind, w)
    assert train == [] and serve == ["fused_field_plain"]
    frozen = ff.FieldWeights(*[t.detach() for t in w])
    got2 = ff.fused_field_train(xyz, d, cond.detach(), ind.detach(), frozen)
    assert train == [] and serve == ["fused_field_plain"] * 2
    assert not any(t.requires_grad for t in got2)
    for a, b, c in zip(got, got2, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    ab, cb = ff.bias_rows(cond.detach(), ind.detach(), frozen)
    for a, b in zip(got, ff.fused_field_train_plain(xyz, d, ab, cb, frozen)[:3]):
        assert torch.equal(a, b)


def test_operand_writers_cover_wgrad_operands_once():
    """Every weight-gradient operand is written by exactly one kernel: the
    train mode's activations (1,184 rows) and the chain's gradients (984);
    the index lists the libraries are held to at load follow WGRAD_OPERANDS."""
    names = [name for name, _ in ff.WGRAD_OPERANDS]
    rows = dict(ff.WGRAD_OPERANDS)
    written = [op for ops in ff.OPERAND_WRITERS.values() for op in ops]
    assert sorted(written) == sorted(names) and len(set(written)) == len(written)
    assert set(ff.OPERAND_WRITERS) == {"fused_field", "fused_field_bwd"}
    assert sum(rows[o] for o in ff.OPERAND_WRITERS["fused_field"]) == 1184
    assert sum(rows[o] for o in ff.OPERAND_WRITERS["fused_field_bwd"]) == 984
    for lib, ops in ff.OPERAND_WRITERS.items():
        assert [names[i] for i in ff.writers_table(lib)] == list(ops)
    assert set(ff.RELU_LAYERS) <= set(ff.OPERAND_WRITERS["fused_field"])


@pytest.mark.parametrize("n", [1, 64, 130])
def test_relu_mask_layout_round_trip(n):
    """pack_relu_masks equals the kernels' word formula (word (f >> 1) & 3,
    bit 2 (f >> 3) + (f & 1) of feature f; csrc/fused_field_common.cuh),
    unpack_relu_masks inverts it, and the words past n are zero."""
    rs = np.random.RandomState(n)
    masks = torch.from_numpy(rs.rand(n, len(ff.RELU_LAYERS), 128) > 0.5)
    words = ff.pack_relu_masks(masks)
    npad = ff.operand_points(n)
    assert words.dtype == torch.int32 and words.shape == (len(ff.RELU_LAYERS), npad, ff.RELU_WORDS)
    want = np.zeros((len(ff.RELU_LAYERS), npad, ff.RELU_WORDS), np.uint64)
    m = masks.numpy()
    for f in range(128):
        want[:, :n, (f >> 1) & 3] |= m[:, :, f].T.astype(np.uint64) << np.uint64(2 * (f >> 3) + (f & 1))
    assert np.array_equal(words.numpy().view(np.uint32), want.astype(np.uint32))
    assert torch.equal(ff.unpack_relu_masks(words, n), masks)
    assert not words[:, n:].any()


def test_pack_operands_zero_fills_the_other_kernels_half():
    """One kernel's half of the operands packs into the whole buffer with
    the other half zero, and the two halves add up to the whole."""
    args = _field(90, 12)
    ops = ff.fused_field_bwd_operands_plain(*args)
    halves = [ff.pack_operands({k: ops[k] for k in names}) for names in ff.OPERAND_WRITERS.values()]
    whole = ff.pack_operands(ops)
    assert all(h.shape == whole.shape for h in halves)
    assert torch.equal(halves[0].float() + halves[1].float(), whole.float())
    back = ff.unpack_operands(halves[0], 90)
    for name, _ in ff.WGRAD_OPERANDS:
        if name in ff.OPERAND_WRITERS["fused_field"]:
            assert torch.equal(back[name].float(), ops[name]), name
        else:
            assert not back[name].float().any(), name
