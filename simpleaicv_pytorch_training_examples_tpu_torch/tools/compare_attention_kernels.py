"""Time the attention kernels of two checkouts of this repository in turns
on one card, and hold their K6 bf16 backwards to the same bits.

    python3 simpleaicv_pytorch_training_examples_tpu_torch/tools/compare_attention_kernels.py \
        --other DIR

DIR is another checkout of the repository (for example an earlier commit
unpacked with ``git archive``); "this" is the checkout that holds this
script. The turns run other, this, this, other, each in a process of its
own that imports the port's package from one checkout, whose kernels
build into that checkout's ``build/kernels``, and times every case at its
main-path shape: K2b's forward and backward at SAM-B's windows with an fp32
and a bf16 bias, at SAM-H's and at N = 1024; K4's at SAM-H's windows on
views of a packed qkv and at SAM-B's; K3's at SAM-B's; K1's, K2's and
K9's at ViT's, forward and backward (a backward through autograd on a kept
graph, as a train step runs it), and K8's (the fused ViT-B/16 block at its train
micro-batch of 64) forward and backward, and the streaming forward of K5
at SAM-B's and SAM-H's global blocks (and at D = 160, N = 1050 and KW =
80, off the main path) and of K6 at SAM2's memory
cross-attention (frame 7's and frame 1's key bias, with and without a
gradient to follow), its memory self-attention and Hiera's global blocks
at d = 64 and 56 (device ms a launch between CUDA events, the card spun
first so that the host queues ahead; SDPA on the same inputs beside each,
with the bias as a mask in the input dtype, and SDPA's backward beside
each backward, a bias as a mask that requires grad; K8 has no one-call
yardstick), and K5's backward at SAM-B's and SAM-H's global blocks and at
the same off-path shapes beside SDPA's backward with the rel bias as a
bf16 mask that requires grad. Each turn also hashes K6's bf16 forward
output at the memory cross-attention (frame 7) from two runs, runs K6's
bf16 backward twice on seeded inputs (SAM2's memory self-attention with
masked slots, Hiera's
global blocks) and hashes its gradients, and holds K1's bf16 forward and backward at Hiera's four
window shapes (SAM2-B+, heads padded from 56 to 64 with the 56-wide
scale) against a float64 computation of the same inputs: the relative L2
error of the output and of dq, dk, dv, and of the plain bf16 version's.
The script prints one JSON line a turn, then one a case with both
checkouts' times (the mean of their turns) and their ratio, and whether
the K6 forward outputs and gradients are equal bit for bit between the
checkouts and between two runs, and one line of each checkout's K1
errors. Needs a CUDA
device.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]
HBM_BYTES_PER_S = 3.35e12   # one H100 SXM
BF16_FLOPS = 989e12
SAM_WINDOWS = 200           # 8 images of 25 windows
ORDER = ("other", "this", "this", "other")   # turns, so that drift shows


def time_ms(torch, fn, iters=30, warmup=3):
    """Device ms a call between two CUDA events, the card spun first."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops):
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def forward_cases(torch, fa):
    """(name, kernel, SDPA, bound ms) of every timed forward; inputs made
    from a seed on the card."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(10)
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)

    def bias_case(b, h, n, d, bias_dtype, spread):
        q, k, v = (randn(b, h, n, d).to(bf16) for _ in range(3))
        bias = (spread * randn(b, h, n, n)).to(bias_dtype)
        mask = bias.to(bf16)
        nbytes = 2 * b * h * n * d * 4 + bias.numel() * bias.element_size()
        return (lambda: fa.fused_attention(q, k, v, bias=bias),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=mask),
                bound_ms(nbytes, 4.0 * b * h * n * n * d))

    def rel_case(b, h, kh, kw, d, dense):
        n = kh * kw
        qkv = randn(b, n, 3 * h * d).to(bf16)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
        lead = (b, n, h) if dense else (b, h, n)
        rel_h, rel_w = randn(*lead, kh), randn(*lead, kw)
        heads_h = rel_h.transpose(1, 2) if dense else rel_h
        heads_w = rel_w.transpose(1, 2) if dense else rel_w
        mask = fa.rel_bias(heads_h, heads_w).to(bf16)
        kernel = ((lambda: fa.fused_attention_relwin_dense(qkv, rel_h, rel_w,
                                                           h)) if dense else
                  (lambda: fa.fused_attention_relwin(q, k, v, rel_h, rel_w)))
        nbytes = 2 * b * h * n * d * 4 + 4 * b * h * n * (kh + kw)
        return (kernel,
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=mask),
                bound_ms(nbytes, 4.0 * b * h * n * n * d))

    def plain_case(b, n, h, d, kind):
        qkv = randn(b, n, 3, h, d).to(bf16)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        kernel = {"K1": lambda: fa.fused_attention_dense(
                      qkv.view(b, n, 3 * h * d), h),
                  "K2": lambda: fa.fused_attention(q, k, v),
                  "K9": lambda: fa.fused_attention_qkv(qkv)}[kind]
        return (kernel, lambda: F.scaled_dot_product_attention(q, k, v),
                bound_ms(2 * b * h * n * d * 4, 4.0 * b * h * n * n * d))

    yield "K2b fwd sam_b", bias_case(SAM_WINDOWS, 12, 196, 64,
                                     torch.float32, 0.3)
    yield "K2b fwd bf16_bias", bias_case(SAM_WINDOWS, 12, 196, 64, bf16, 3.0)
    yield "K2b fwd sam_h", bias_case(SAM_WINDOWS, 16, 196, 80,
                                     torch.float32, 3.0)
    yield "K2b fwd streamed_n1024", bias_case(8, 2, 1024, 128,
                                              torch.float32, 3.0)
    yield "K4 fwd sam_h", rel_case(SAM_WINDOWS, 16, 14, 14, 80, dense=False)
    yield "K3 fwd sam_b", rel_case(SAM_WINDOWS, 12, 14, 14, 64, dense=True)
    # K3's shape through K4's entry, the rel terms [B, H, N, K] contiguous
    yield "K4 fwd sam_b", rel_case(SAM_WINDOWS, 12, 14, 14, 64, dense=False)
    yield "K1 fwd vit_b16", plain_case(256, 197, 12, 64, "K1")
    yield "K2 fwd vit_h14", plain_case(256, 257, 16, 80, "K2")
    yield "K9 fwd vit_b16", plain_case(256, 197, 12, 64, "K9")


def backward_cases(torch, fa, ab):
    """(name, kernel, SDPA's backward or None, bound ms) of K1's, K2's and
    K9's backward at ViT's shapes, of K2b's, K3's and K4's at SAM's windows
    (SDPA's backward with the bias as a mask in the input dtype that
    requires grad), and of K8's forward and backward; inputs made from a
    seed on the card."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(30)
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    grad = torch.autograd.grad

    def plain_case(b, n, h, d, kind):
        qkv = randn(b, n, 3, h, d).to(bf16)
        dout = randn(b, n, h, d).to(bf16)       # [B, N, H, D]
        heads = dout.transpose(1, 2)            # [B, H, N, D]
        if kind == "K2":
            leaves = [t.requires_grad_() for t in
                      qkv.permute(2, 0, 3, 1, 4).unbind(0)]
            out = fa.fused_attention(*leaves)
            kernel = lambda: grad(out, leaves, heads, retain_graph=True)
        else:
            x = (qkv.view(b, n, 3 * h * d) if kind == "K1" else
                 qkv).requires_grad_()
            out = (fa.fused_attention_dense(x, h) if kind == "K1" else
                   fa.fused_attention_qkv(x))
            g = dout.view(b, n, h * d) if kind == "K1" else dout
            kernel = lambda: grad(out, x, g, retain_graph=True)
        ref = [t.detach().requires_grad_() for t in
               qkv.permute(2, 0, 3, 1, 4).unbind(0)]
        ref_out = F.scaled_dot_product_attention(*ref)
        library = lambda: grad(ref_out, ref, heads, retain_graph=True)
        # qkv and dout read, dqkv written; the five products
        return (kernel, library, bound_ms(7 * b * n * h * d * 2,
                                          10.0 * b * h * n * n * d))

    def bias_case(b, h, n, d, bias_dtype, spread):
        q, k, v = (randn(b, h, n, d).to(bf16) for _ in range(3))
        bias = (spread * randn(b, h, n, n)).to(bias_dtype)
        dout = randn(b, n, h, d).to(bf16).transpose(1, 2)
        leaves = [t.requires_grad_() for t in (q, k, v, bias)]
        out = fa.fused_attention(*leaves[:3], bias=leaves[3])
        ref = [t.detach().to(bf16).requires_grad_() for t in leaves]
        ref_out = F.scaled_dot_product_attention(*ref[:3], attn_mask=ref[3])
        # q, k, v, dout read and dq, dk, dv written; the bias read and its
        # gradient written
        nbytes = 7 * b * h * n * d * 2 + 2 * bias.numel() * bias.element_size()
        return (lambda: grad(out, leaves, dout, retain_graph=True),
                lambda: grad(ref_out, ref, dout, retain_graph=True),
                bound_ms(nbytes, 10.0 * b * h * n * n * d))

    def rel_case(b, h, kh, kw, d, dense):
        n = kh * kw
        qkv = randn(b, n, 3 * h * d).to(bf16)
        lead = (b, n, h) if dense else (b, h, n)
        rel_h, rel_w = randn(*lead, kh), randn(*lead, kw)
        dout = randn(b, n, h * d).to(bf16)
        heads = lambda t: t.transpose(1, 2) if dense else t
        if dense:
            leaves = [t.requires_grad_() for t in (qkv, rel_h, rel_w)]
            out = fa.fused_attention_relwin_dense(*leaves, h)
            g = dout
        else:   # K4 on views of the packed qkv, as SAM's attention calls it
            views = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
            leaves = [t.detach().requires_grad_()
                      for t in (*views, rel_h, rel_w)]
            out = fa.fused_attention_relwin(*leaves)
            g = dout.view(b, n, h, d).transpose(1, 2)
        ref = [t.detach().requires_grad_() for t in
               qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)]
        mask = fa.rel_bias(heads(rel_h), heads(rel_w)).to(bf16).requires_grad_()
        ref_out = F.scaled_dot_product_attention(*ref, attn_mask=mask)
        ref_g = dout.view(b, n, h, d).transpose(1, 2)
        # qkv, dout read and dqkv written; the rel terms read and their
        # gradients written
        nbytes = 7 * b * h * n * d * 2 + 2 * 4 * b * h * n * (kh + kw)
        return (lambda: grad(out, leaves, g, retain_graph=True),
                lambda: grad(ref_out, (*ref, mask), ref_g, retain_graph=True),
                bound_ms(nbytes, 10.0 * b * h * n * n * d))

    def block_case(b, n, h, d, backward):
        c = h * d
        x = randn(b, n, c).to(bf16)
        weights = [(randn(3 * c, c) * c ** -0.5).to(bf16),
                   (0.02 * randn(3 * c)).to(bf16),
                   (randn(c, c) * c ** -0.5).to(bf16),
                   (0.02 * randn(c)).to(bf16), 1.0 + 0.1 * randn(c),
                   0.1 * randn(c)]
        if not backward:
            return (lambda: ab.attn_block(x, *weights, h), None,
                    bound_ms(2 * (2 * b * n * c + 4 * c * c + 4 * c),
                             b * (8.0 * n * c * c + 4.0 * n * n * c)))
        leaves = [t.requires_grad_() for t in [x] + weights]
        out = ab.attn_block(*leaves, h)
        dy = randn(b, n, c).to(bf16)
        # the recompute counted: 22NC^2 + 12N^2C a sample
        return (lambda: grad(out, leaves, dy, retain_graph=True), None,
                bound_ms(2 * (3 * b * n * c + 2 * (4 * c * c + 4 * c)),
                         b * (22.0 * n * c * c + 12.0 * n * n * c)))

    yield "K1 bwd vit_b16", plain_case(256, 197, 12, 64, "K1")
    yield "K2 bwd vit_h14", plain_case(256, 257, 16, 80, "K2")
    yield "K9 bwd vit_b16", plain_case(256, 197, 12, 64, "K9")
    yield "K2b bwd sam_b", bias_case(SAM_WINDOWS, 12, 196, 64, torch.float32,
                                     0.3)
    yield "K2b bwd bf16_bias", bias_case(SAM_WINDOWS, 12, 196, 64, bf16, 3.0)
    yield "K2b bwd sam_h", bias_case(SAM_WINDOWS, 16, 196, 80, torch.float32,
                                     3.0)
    yield "K2b bwd streamed_n1024", bias_case(8, 2, 1024, 128, torch.float32,
                                              3.0)
    yield "K3 bwd sam_b", rel_case(SAM_WINDOWS, 12, 14, 14, 64, dense=True)
    yield "K4 bwd sam_h", rel_case(SAM_WINDOWS, 16, 14, 14, 80, dense=False)
    # K3's shape through K4's entry, the rel terms [B, H, N, K] contiguous
    yield "K4 bwd sam_b", rel_case(SAM_WINDOWS, 12, 14, 14, 64, dense=False)
    yield "K8 fwd vit_b16_train", block_case(64, 197, 12, 64, False)
    yield "K8 bwd vit_b16_train", block_case(64, 197, 12, 64, True)


def slot_bias(torch, slots, pointers):
    """SAM2's memory key bias [1, 7 x 4096 + 16 x 4]: 0 on the first
    ``slots`` memory slots and ``pointers`` object pointers, -1e9 on the
    rest (frame 7: 7 and 8; frame 1: 1 and 1)."""
    bias = torch.full((1, 7 * 4096 + 64), -1e9, device="cuda")
    bias[:, :slots * 4096] = 0.0
    bias[:, 7 * 4096:7 * 4096 + 4 * pointers] = 0.0
    return bias


def flash_forward_cases(torch, fl):
    """(name, kernel, SDPA, bound ms) of K5's and K6's forward at their
    main-path shapes: K5 at SAM-B's and SAM-H's global blocks on views of
    a packed qkv, and at chip_smoke.py's off-path shapes (SDPA with the rel
    bias as a bf16 [B, H, N, N] mask); K6
    at SAM2's memory cross-attention with frame 7's and frame 1's bias,
    with and without a gradient to follow (P's residual), its memory
    self-attention and Hiera's global blocks at d = 64 (heads padded from
    56, the 56-wide scale) and 56, each in its caller's layout (SDPA with
    the key bias as a bf16 [B, 1, 1, Nk] mask). The bound counts q, k, v,
    the output and the fp32 terms once, and the products of the keys that
    are not masked."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(50)
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)

    def rel_case(b, h, kh, kw, d):
        n = kh * kw
        qkv = randn(b, n, 3 * h * d).to(bf16)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
        rel_h, rel_w = randn(b, h, n, kh), randn(b, h, n, kw)
        mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
            b, h, n, n).to(bf16)
        nbytes = 2 * b * h * n * d * 4 + 4 * b * h * n * (kh + kw + 1)
        return (lambda: fl.flash_attention_relpos(q, k, v, rel_h, rel_w),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=mask),
                bound_ms(nbytes, 4.0 * b * h * n * n * d))

    def key_case(b, h, nq, nk, d, bias, scale, layout, grad):
        if layout == "packed":      # Hiera's global blocks: views of a qkv
            qkv = randn(b, nq, 3 * h * d).to(bf16)
            q, k, v = qkv.view(b, nq, 3, h, d).permute(2, 0, 3, 1,
                                                       4).unbind(0)
        else:                       # SAM2's RoPEAttention
            q = randn(b, nq, h, d).to(bf16).transpose(1, 2)
            k = randn(b, h, nk, d).to(bf16)
            v = randn(b, nk, h, d).to(bf16).transpose(1, 2)
        leaves = [t.detach().requires_grad_(grad) for t in (q, k, v)]
        mask = None if bias is None else bias[:, None, None, :].to(bf16)
        valid = nk if bias is None else int((bias[0] > -5e8).sum())
        nbytes = 2 * b * h * d * (2 * nq + 2 * nk) + 4 * b * nk + 4 * b * h * nq
        return (lambda: fl.flash_attention(*leaves, bias, scale),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                       scale=scale),
                bound_ms(nbytes, 4.0 * b * h * nq * valid * d))

    cross = (1, 1, 4096, 7 * 4096 + 64, 256)
    hiera = 56 ** -0.5
    yield "K5 fwd sam_b", rel_case(8, 12, 64, 64, 64)
    yield "K5 fwd sam_h_d80", rel_case(2, 16, 64, 64, 80)
    # chip_smoke.py's off-path K5 shapes: D = 160, N = 1050, KW = 80
    yield "K5 fwd head_dim_160", rel_case(1, 2, 32, 32, 160)
    yield "K5 fwd n1050_kh30_kw35", rel_case(1, 4, 30, 35, 64)
    yield "K5 fwd kh48_kw80", rel_case(2, 4, 48, 80, 64)
    for frame, slots, pointers in ((7, 7, 8), (1, 1, 1)):
        for grad in (False, True):
            yield (f"K6 fwd memory_cross_frame{frame}"
                   + (" grad" if grad else ""),
                   key_case(*cross, slot_bias(torch, slots, pointers), None,
                            "memory", grad))
    yield "K6 fwd memory_self", key_case(1, 1, 4096, 4096, 256, None, None,
                                         "memory", False)
    yield "K6 fwd hiera_global", key_case(1, 8, 4096, 4096, 64, None, hiera,
                                          "packed", False)
    yield "K6 fwd hiera_global_d56", key_case(1, 8, 4096, 4096, 56, None,
                                              None, "packed", False)


def flash_backward_cases(torch, fl):
    """(name, kernel, SDPA's backward, bound ms) of K5's backward at SAM-B's
    and SAM-H's global blocks on views of a packed qkv, and at
    chip_smoke.py's off-path shapes (D = 160, N = 1050, KW = 80): the
    backward through autograd on a kept graph, beside SDPA's backward with
    the rel bias as a bf16 [B, H, N, N] mask that requires grad (its
    gradient is not reduced to drel). The bound counts q, k, v, dout, the
    output and the gradients once, the fp32 rel terms, their gradients and
    the log-sum-exp once, against the five products."""
    F = torch.nn.functional
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(60)
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    grad = torch.autograd.grad

    def rel_case(b, h, kh, kw, d):
        n = kh * kw
        qkv = randn(b, n, 3 * h * d).to(bf16)
        views = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
        rel_h, rel_w = randn(b, h, n, kh), randn(b, h, n, kw)
        dout = randn(b, n, h, d).to(bf16).transpose(1, 2)
        leaves = [t.detach().requires_grad_()
                  for t in (*views, rel_h, rel_w)]
        out = fl.flash_attention_relpos(*leaves)
        ref = [t.detach().requires_grad_() for t in views]
        mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
            b, h, n, n).to(bf16).requires_grad_()
        ref_out = F.scaled_dot_product_attention(*ref, attn_mask=mask)
        nbytes = (2 * b * h * n * d * 8
                  + 4 * b * h * n * (2 * (kh + kw) + 1))
        return (lambda: grad(out, leaves, dout, retain_graph=True),
                lambda: grad(ref_out, (*ref, mask), dout, retain_graph=True),
                bound_ms(nbytes, 10.0 * b * h * n * n * d))

    yield "K5 bwd sam_b", rel_case(8, 12, 64, 64, 64)
    yield "K5 bwd sam_h_d80", rel_case(2, 16, 64, 64, 80)
    yield "K5 bwd head_dim_160", rel_case(1, 2, 32, 32, 160)
    yield "K5 bwd n1050_kh30_kw35", rel_case(1, 4, 30, 35, 64)
    yield "K5 bwd kh48_kw80", rel_case(2, 4, 48, 80, 64)


def key_bias_forward_digest(torch, fl):
    """run() of K6's bf16 forward at SAM2's memory cross-attention with
    frame 7's bias (split keys), returning out and lse."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = (torch.randn(1, 1, n, 256, device="cuda", generator=gen).to(
        torch.bfloat16) for n in (4096, 7 * 4096 + 64, 7 * 4096 + 64))
    bias = slot_bias(torch, 7, 8)
    return lambda: fl.flash_attention(q, k, v, bias, return_lse=True)


def key_bias_backward_cases(torch, fl):
    """(name, run) of K6's bf16 backward on seeded inputs; run() returns
    dq, dk, dv."""
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(20)
    randn = lambda *s: torch.randn(*s, device="cuda", generator=gen)

    def case(b, h, nq, nk, d, masked_keys, scale):
        q, k, v = (randn(b, h, n, d).to(bf16) for n in (nq, nk, nk))
        dout = randn(b, h, nq, d).to(bf16)
        bias = None
        if masked_keys:   # the last memory slots empty
            bias = torch.zeros(b, nk, device="cuda")
            bias[:, nk - masked_keys:] = -1e9
        leaves = [t.requires_grad_() for t in (q, k, v)]
        out = fl.flash_attention(*leaves, bias, scale)
        return lambda: torch.autograd.grad(out, leaves, dout,
                                           retain_graph=True)

    # 7 slots of 512 keys, 3 of them empty
    yield "K6 bwd memory slots", case(1, 1, 4096, 7 * 512, 256, 3 * 512,
                                      None)
    yield "K6 bwd hiera global", case(4, 8, 4096, 4096, 64, 0, 56 ** -0.5)


def hiera_accuracy(torch, fa):
    """{window: {out, dq, dk, dv and their "_plain" twins: relative L2
    error against float64}} of K1 at Hiera's window shapes: q, k, v and
    dout of unit scale in bf16, the padded columns 56-63 zero as the
    model's padded heads give them."""
    gen = torch.Generator(device="cuda").manual_seed(40)
    scale, d = 56 ** -0.5, 64
    out = {}
    for b, n, h in ((256, 64, 2), (256, 16, 4), (25, 196, 8), (25, 49, 16)):
        x = torch.randn(b, n, 3, h, d, device="cuda", generator=gen)
        dout = torch.randn(b, n, h, d, device="cuda", generator=gen)
        x[..., 56:] = 0
        dout[..., 56:] = 0
        x = x.reshape(b, n, 3 * h * d).to(torch.bfloat16)
        dout = dout.reshape(b, n, h * d).to(torch.bfloat16)
        leaf = x.clone().requires_grad_()
        y = fa.fused_attention_dense(leaf, h, None, scale)
        (dx,) = torch.autograd.grad(y, leaf, dout)
        x64 = x.double().requires_grad_()
        q, k, v = x64.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
        p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) * scale, -1)
        y64 = torch.einsum("bhqk,bhkd->bhqd", p, v).transpose(1, 2).reshape(
            b, n, h * d)
        (dx64,) = torch.autograd.grad(y64, x64, dout.double())
        y_plain = fa.fused_attention_dense_reference(x, h, None, scale)
        dx_plain = fa.fused_attention_dense_backward_reference(
            x, dout, h, None, scale)
        rel = lambda a, r: ((a.double() - r).norm() / r.norm()).item()
        thirds = lambda t: t.view(b, n, 3, h * d).unbind(2)
        record = {"out": rel(y, y64), "out_plain": rel(y_plain, y64)}
        for name, a, a_plain, r in zip(("dq", "dk", "dv"), thirds(dx),
                                       thirds(dx_plain), thirds(dx64)):
            record[name], record[name + "_plain"] = rel(a, r), rel(a_plain, r)
        out[f"hiera_n{n}"] = record
    return out


def digest(torch, tensors):
    """The first 16 hex digits of the sha256 of bf16 tensors' bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.int16).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def worker(root, build_only):
    """One turn: import the package from ``root`` and print one JSON line."""
    sys.path.insert(0, str(root))
    import torch
    from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
        attn_block as ab, build, flash_attention as fl, fused_attention as fa)
    build.build()
    if build_only:
        return
    record = {"root": str(root), "card": torch.cuda.get_device_name(0),
              "cases": {}}
    for name, (kernel, library, bound) in forward_cases(torch, fa):
        with torch.no_grad():
            record["cases"][name] = {"ms": time_ms(torch, kernel),
                                     "library_ms": time_ms(torch, library),
                                     "bound_ms": bound}
        torch.cuda.empty_cache()
    for name, (kernel, library, bound) in flash_forward_cases(torch, fl):
        record["cases"][name] = {"ms": time_ms(torch, kernel, iters=20),
                                 "library_ms": time_ms(torch, library,
                                                       iters=20),
                                 "bound_ms": bound}
        torch.cuda.empty_cache()
    run = key_bias_forward_digest(torch, fl)
    first, second = digest(torch, run()[:1]), digest(torch, run()[:1])
    record["cases"]["K6 fwd digest memory_cross_frame7"] = {
        "ms": time_ms(torch, run, iters=5), "digest": first,
        "reproducible": first == second}
    for name, (kernel, library, bound) in flash_backward_cases(torch, fl):
        record["cases"][name] = {"ms": time_ms(torch, kernel, iters=10),
                                 "library_ms": time_ms(torch, library,
                                                       iters=10),
                                 "bound_ms": bound}
        torch.cuda.empty_cache()
    for name, (kernel, library, bound) in backward_cases(torch, fa, ab):
        record["cases"][name] = {
            "ms": time_ms(torch, kernel),
            "library_ms": None if library is None else time_ms(torch, library),
            "bound_ms": bound}
        torch.cuda.empty_cache()
    for name, run in key_bias_backward_cases(torch, fl):
        first, second = digest(torch, run()), digest(torch, run())
        record["cases"][name] = {"ms": time_ms(torch, run, iters=5),
                                 "digest": first,
                                 "reproducible": first == second}
        torch.cuda.empty_cache()
    record["k1_vs_float64"] = hiera_accuracy(torch, fa)
    print(json.dumps(record), flush=True)


def run_turn(root, build_only=False):
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--worker", str(root)]
                         + (["--build-only"] if build_only else []),
                         cwd=root, capture_output=True, text=True,
                         env=dict(os.environ))
    if out.returncode != 0:
        raise SystemExit(f"turn in {root} failed:\n{out.stdout}\n"
                         f"{out.stderr[-4000:]}")
    return out.stdout


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path,
                        help="the other checkout's root (required)")
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--build-only", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        worker(args.worker.resolve(), args.build_only)
        return
    if args.other is None:
        parser.error("--other is required")
    roots = {"this": THIS, "other": args.other.resolve()}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    builds = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                "--worker", str(r), "--build-only"], cwd=r)
              for r in roots.values()]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a kernel build failed")
    turns = {"this": [], "other": []}
    accuracy = {}
    for which in ORDER:
        record = json.loads(run_turn(roots[which]).strip().splitlines()[-1])
        record["turn"] = which
        print(json.dumps(record), flush=True)
        turns[which].append(record["cases"])
        accuracy[which] = record["k1_vs_float64"]
    for name in turns["this"][0]:
        mean = lambda key, side: sum(t[name][key] for t in turns[side]) / len(
            turns[side])
        line = {"case": name, "this_ms": [t[name]["ms"] for t in turns["this"]],
                "other_ms": [t[name]["ms"] for t in turns["other"]],
                "speedup": mean("ms", "other") / mean("ms", "this")}
        if "digest" in turns["this"][0][name]:
            digests = {t[name]["digest"] for s in turns.values() for t in s}
            line["same_bits_in_both"] = len(digests) == 1
            line["reproducible"] = all(t[name]["reproducible"]
                                       for s in turns.values() for t in s)
        elif turns["this"][0][name]["library_ms"] is None:
            line["bound_ms"] = turns["this"][0][name]["bound_ms"]
        else:
            line["library_ms"] = mean("library_ms", "this")
            line["bound_ms"] = turns["this"][0][name]["bound_ms"]
            line["this_over_library"] = mean("ms", "this") / line["library_ms"]
        print(json.dumps(line), flush=True)
    for which, errors in accuracy.items():
        print(json.dumps({"k1_vs_float64": which, **errors}), flush=True)


if __name__ == "__main__":
    main()
