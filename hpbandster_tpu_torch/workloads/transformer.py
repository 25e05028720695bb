"""Transformer hyperparameter-search workload: a decoder-only transformer
(pre-LN, causal multi-head attention and MLP blocks) trained on a
synthetic COPY task, every config at once.

Ported from ``hpbandster_tpu/workloads/transformer.py``, dense attention
only. Each sequence is ``[prefix, SEP, prefix]`` with the prefix drawn
uniformly; the copied half is predictable only by attending back across
the separator, and validation prefixes are fresh draws. Parameters stack
on a leading config axis; activations are ``[n, B, T, d]``.

Precision follows the reference: every matrix product (projections,
attention scores and mixing, the MLP, the head) takes bfloat16 operands
and accumulates in float32. The port rounds the operands to bfloat16 and
multiplies them as float32 (each product of two bfloat16 values is exact
in float32), so the CPU and the card compute the same function; keep
TF32 off for that. Layer norms (eps 1e-6), softmax and the optimizer are
float32. The attention is written as the reference writes it: scores,
causal mask (-1e30), softmax. Budget = SGD steps.

The reference's sequence-parallel forward (ring attention across devices)
is not ported: the port runs on one device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hpbandster_tpu_torch.workloads.train import (
    decode_sgd_hparams,
    lane_scaled,
    momentum_sgd_train,
    sgd_space,
    workload_inputs,
)

__all__ = [
    "TransformerConfig",
    "TRANSFORMER_TARGET_VAL_ACCURACY",
    "transformer_space",
    "decode_transformer_hparams",
    "draw_transformer_unit_params",
    "init_transformer_params",
    "transformer_forward",
    "make_copy_dataset",
    "make_transformer_eval_fn",
    "make_transformer_error_fn",
    "make_transformer_accuracy_fn",
]

#: the reference's documented target for the default config (its data
#: seed 0, budget 81 steps): chance on the copied half is 1/32; its best of
#: 12 random draws reached 0.395
TRANSFORMER_TARGET_VAL_ACCURACY = 0.35


class TransformerConfig(NamedTuple):
    vocab: int = 32          # payload tokens; id ``vocab`` is the separator
    prefix_len: int = 31     # sequence = prefix + SEP + prefix (len 2P+1)
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256          # 4 * d_model
    n_train: int = 512
    n_val: int = 256
    batch_size: int = 128

    @property
    def seq_len(self) -> int:
        return 2 * self.prefix_len + 1


transformer_space = sgd_space
decode_transformer_hparams = decode_sgd_hparams

#: leaves every lane starts from as they are (the layer norms' gains and
#: biases); every other leaf scales with ``init_scale``
_UNSCALED = ("ln_f", "ln_f_b", "ln1", "ln1_b", "ln2", "ln2_b")


def draw_transformer_unit_params(generator: torch.Generator,
                                 cfg: TransformerConfig) -> dict:
    """The initial weights at ``init_scale = 1``; dense weights ``[d_in,
    d_out]``."""
    dev, d = generator.device, cfg.d_model
    n_tok = cfg.vocab + 1  # + separator

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def dense(d_in, d_out):
        return (2.0 / d_in) ** 0.5 * normal(d_in, d_out)

    params = {
        "tok_emb": 0.02 * normal(n_tok, d),
        "pos_emb": 0.02 * normal(cfg.seq_len - 1, d),
        "head": dense(d, n_tok),
        "ln_f": torch.ones(d, device=dev),
        "ln_f_b": torch.zeros(d, device=dev),
    }
    for i in range(cfg.n_layers):
        params[f"l{i}"] = {
            "wq": dense(d, d), "wk": dense(d, d), "wv": dense(d, d), "wo": dense(d, d),
            "w1": dense(d, cfg.d_ff), "w2": dense(cfg.d_ff, d),
            "ln1": torch.ones(d, device=dev), "ln1_b": torch.zeros(d, device=dev),
            "ln2": torch.ones(d, device=dev), "ln2_b": torch.zeros(d, device=dev),
        }
    return params


def init_transformer_params(unit: dict, init_scale: torch.Tensor) -> dict:
    """One lane per config: the weights times ``init_scale[i]``, the layer
    norms as they are."""
    return lane_scaled(unit, init_scale, keep=_UNSCALED)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and held as float32."""
    return x.to(torch.bfloat16).float()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` ``[n, ..., k]`` times ``b`` ``[n, k, m]`` per lane: bfloat16
    operands, float32 accumulation."""
    n, k = a.shape[0], a.shape[-1]
    out = torch.bmm(_bf16(a).reshape(n, -1, k), _bf16(b))
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _ln(x, g, b):
    """Layer norm over the last dim, eps 1e-6; ``g``/``b`` ``[n, d]``."""
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    shape = (g.shape[0],) + (1,) * (x.dim() - 2) + (g.shape[1],)
    return g.reshape(shape) * (x - m) * torch.rsqrt(v + 1e-6) + b.reshape(shape)


def _dense_attention(q, k, v, scale):
    """Causal attention of ``[n, B, T, H, dh]`` blocks: bfloat16 score and
    mixing products with float32 accumulation, the -1e30 mask, softmax in
    float32."""
    t = q.shape[2]
    s = torch.einsum("nbqhd,nbkhd->nbhqk", _bf16(q), _bf16(k)) * scale
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, -1e30)
    att = torch.softmax(s, dim=-1)
    return torch.einsum("nbhqk,nbkhd->nbqhd", _bf16(att), _bf16(v))


def _layer(x, p, n_heads):
    """One pre-LN block: attention, then the MLP."""
    n, bsz, t, d = x.shape
    dh = d // n_heads
    h = _ln(x, p["ln1"], p["ln1_b"])
    q = _mm(h, p["wq"]).reshape(n, bsz, t, n_heads, dh)
    k = _mm(h, p["wk"]).reshape(n, bsz, t, n_heads, dh)
    v = _mm(h, p["wv"]).reshape(n, bsz, t, n_heads, dh)
    x = x + _mm(_dense_attention(q, k, v, dh ** -0.5).reshape(n, bsz, t, d), p["wo"])
    h = _ln(x, p["ln2"], p["ln2_b"])
    return x + _mm(torch.relu(_mm(h, p["w1"])), p["w2"])


def transformer_forward(params: dict, tokens: torch.Tensor,
                        cfg: TransformerConfig) -> torch.Tensor:
    """``tokens`` int64 ``[B, T]`` (T = seq_len - 1 teacher-forced inputs)
    -> logits ``[n, B, T, vocab + 1]``."""
    x = params["tok_emb"][:, tokens] + params["pos_emb"].unsqueeze(1)
    for i in range(cfg.n_layers):
        x = _layer(x, params[f"l{i}"], cfg.n_heads)
    x = _ln(x, params["ln_f"], params["ln_f_b"])
    return _mm(x, params["head"])


def make_copy_dataset(generator: torch.Generator, cfg: TransformerConfig):
    """``((x_tr, y_tr), (x_val, y_val), loss_mask)``: ``x`` the
    teacher-forced inputs ``seq[:, :-1]``, ``y`` the targets ``seq[:, 1:]``
    (int64), ``loss_mask`` ``f32[T]`` selecting the copied half."""
    dev = generator.device

    def draw(n):
        prefix = torch.randint(0, cfg.vocab, (n, cfg.prefix_len), generator=generator,
                               device=dev)
        sep = torch.full((n, 1), cfg.vocab, dtype=prefix.dtype, device=dev)
        seq = torch.cat([prefix, sep, prefix], dim=1)
        return seq[:, :-1], seq[:, 1:]

    train = draw(cfg.n_train)
    val = draw(cfg.n_val)
    t = cfg.seq_len - 1
    loss_mask = (torch.arange(t, device=dev) >= cfg.prefix_len).to(torch.float32)
    return train, val, loss_mask


def _masked_xent(params, xb, yb, cfg, mask):
    """Cross-entropy over the copied half, per lane: ``f32[n]``."""
    logp = torch.log_softmax(transformer_forward(params, xb, cfg), dim=-1)
    n = logp.shape[0]
    idx = yb.unsqueeze(0).expand(n, -1, -1).unsqueeze(-1)
    nll = -logp.gather(-1, idx).squeeze(-1)
    return (nll * mask).sum(dim=(1, 2)) / (mask.sum() * xb.shape[0])


def _masked_accuracy(params, x, y, cfg, mask):
    with torch.no_grad():
        hit = (torch.argmax(transformer_forward(params, x, cfg), -1) == y).to(torch.float32)
        return (hit * mask).sum(dim=(1, 2)) / (mask.sum() * x.shape[0])


def _inputs(cfg, data_seed, device, data, init):
    return workload_inputs(device, data_seed, data, init,
                           lambda g: make_copy_dataset(g, cfg),
                           lambda g: draw_transformer_unit_params(g, cfg))


def _train_transformer(vectors, budget, train, cfg, unit, mask):
    lr, momentum, wd, scale = decode_transformer_hparams(vectors)

    def loss_fn(p, xb, yb):
        return _masked_xent(p, xb, yb, cfg, mask)

    return momentum_sgd_train(init_transformer_params(unit, scale), lr, momentum, wd,
                              train, budget, loss_fn, cfg.batch_size, cfg.n_train)


def make_transformer_eval_fn(cfg: TransformerConfig = TransformerConfig(),
                             data_seed: int = 0, device=None, data=None,
                             init: Optional[dict] = None):
    """``eval_fn(vectors f32[n, 4], budget) -> f32[n]`` masked validation
    cross-entropy after ``budget`` SGD steps."""
    _, (train, val, mask), unit = _inputs(cfg, data_seed, device, data, init)

    def eval_fn(vectors: torch.Tensor, budget) -> torch.Tensor:
        params = _train_transformer(vectors, budget, train, cfg, unit, mask)
        with torch.no_grad():
            return _masked_xent(params, val[0], val[1], cfg, mask)

    return eval_fn


def make_transformer_error_fn(cfg: TransformerConfig = TransformerConfig(),
                              data_seed: int = 0, device=None, data=None,
                              init: Optional[dict] = None):
    """``eval_fn(vectors, budget) -> f32[n]``, ``1 -`` the copied half's
    validation accuracy, read against ``TRANSFORMER_TARGET_VAL_ACCURACY``."""
    _, (train, val, mask), unit = _inputs(cfg, data_seed, device, data, init)

    def eval_fn(vectors: torch.Tensor, budget) -> torch.Tensor:
        params = _train_transformer(vectors, budget, train, cfg, unit, mask)
        return 1.0 - _masked_accuracy(params, val[0], val[1], cfg, mask)

    return eval_fn


def make_transformer_accuracy_fn(cfg: TransformerConfig = TransformerConfig(),
                                 data_seed: int = 0, device=None, data=None,
                                 init: Optional[dict] = None):
    """``acc_fn(vectors, budget) -> (train_acc f32[n], val_acc f32[n])`` on
    the copied half."""
    _, (train, val, mask), unit = _inputs(cfg, data_seed, device, data, init)

    def acc_fn(vectors: torch.Tensor, budget):
        params = _train_transformer(vectors, budget, train, cfg, unit, mask)
        return tuple(_masked_accuracy(params, x, y, cfg, mask) for x, y in (train, val))

    return acc_fn
