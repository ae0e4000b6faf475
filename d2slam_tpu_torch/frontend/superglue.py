"""SuperGlue-style attentional feature matcher.

Counterpart of ``d2slam_tpu/frontend/superglue.py`` (reference: the
optional learned matcher of d2frontend/src/CNN/superglue_onnx.cpp, used
for local and remote matching when ``enable_superglue_local`` /
``_remote`` is set). Sarlin et al. 2020: a keypoint MLP positional
encoder, alternating self- and cross-attention layers over both sets, a
final projection and log-domain Sinkhorn optimal transport with a
learned dustbin.

The module is built from the JAX package's parameter layout (numpy):
``{"kenc1": {"w": [3, 64], "b"}, "kenc2", "self{l}" / "cross{l}": {"q",
"k", "v", "mlp1", "mlp2"}, "final", "dustbin"}``, with dense weights as
[cin, cout]. Attention and Sinkhorn are plain torch ops (matmul,
softmax, logsumexp): the JAX package computes them outside any Pallas
kernel. Masked logits are filled with -1e9, not -inf, as there, so a
query whose keys are all masked gets a uniform softmax (``torch``'s
``scaled_dot_product_attention`` would give NaN there).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from d2slam_tpu_torch.utils.device import resolve_device, to_f32

_MASKED = -1e9


@dataclasses.dataclass(frozen=True)
class SuperGlueConfig:
    desc_dim: int = 256
    num_layers: int = 9          # self+cross pairs (reference uses 9)
    num_heads: int = 4
    sinkhorn_iters: int = 30
    match_threshold: float = 0.2


# the compact configuration the shipped weights (weights/superglue_synth.npz)
# were trained with (the JAX package's train_superglue recipe)
COMPACT = SuperGlueConfig(num_layers=3, num_heads=4, sinkhorn_iters=20)

_ATTN = ("q", "k", "v", "mlp1", "mlp2")


def superglue_init(generator: torch.Generator,
                   cfg: SuperGlueConfig = SuperGlueConfig()) -> Dict:
    """He-normal dense weights and zero biases in the JAX layout (numpy
    float32), drawn from ``generator`` in the JAX package's layer order;
    ``dustbin`` = 1. (``jax.random`` streams cannot be reproduced here:
    parity tests carry the JAX parameters across instead.)"""
    D = cfg.desc_dim

    def dense(cin, cout):
        w = torch.randn((cin, cout), generator=generator, dtype=torch.float32)
        return {"w": (w * math.sqrt(2.0 / cin)).numpy(), "b": np.zeros(cout, np.float32)}

    params: Dict = {"kenc1": dense(3, 64), "kenc2": dense(64, D)}
    for layer in range(cfg.num_layers):
        for kind in ("self", "cross"):
            params[f"{kind}{layer}"] = {
                "q": dense(D, D), "k": dense(D, D), "v": dense(D, D),
                "mlp1": dense(2 * D, 2 * D), "mlp2": dense(2 * D, D)}
    params["final"] = dense(D, D)
    params["dustbin"] = np.ones((), np.float32)
    return params


def superglue_params_from_numpy(raw: Mapping) -> Dict:
    """The JAX layout (nested dict of float32 numpy; tensor leaves are
    kept as they are) from any of the
    layouts the JAX package writes: the nested dict of
    ``train_frontend.load_weights`` (npz keys such as ``cross0/k/w``), an
    ``np.load`` of such an npz, or the flat ``name_w`` layout of
    ``superglue.load_params`` (``{"cross0_k": {"w", "b"}}``)."""
    leaves: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, Mapping) or hasattr(node, "files"):
            for k in node.keys():
                walk(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif torch.is_tensor(node):
            leaves[prefix] = node
        else:
            leaves[prefix] = np.asarray(node, np.float32)

    walk("", raw)
    out: Dict = {}
    for path, v in leaves.items():
        parts = path.replace("_", "/").split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def log_sinkhorn(scores: torch.Tensor, dustbin: torch.Tensor, iters: int) -> torch.Tensor:
    """Log-domain Sinkhorn with a dustbin row and column (SuperGlue's
    optimal-transport head). scores [N, M] -> log assignment [N+1, M+1]."""
    N, M = scores.shape
    aug = dustbin.to(scores.dtype).expand(N + 1, M + 1).clone()
    aug[:N, :M] = scores
    zeros_n = scores.new_zeros(N)
    zeros_m = scores.new_zeros(M)
    log_mu = torch.cat([zeros_n, scores.new_tensor([math.log(float(M))])])
    log_nu = torch.cat([zeros_m, scores.new_tensor([math.log(float(N))])])
    u = scores.new_zeros(N + 1)
    v = scores.new_zeros(M + 1)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(aug + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(aug + u[:, None], dim=0)
    return aug + u[:, None] + v[None, :]


class SuperGlue(nn.Module):
    """SuperGlue built from the JAX layout's params on ``device`` (default
    ``cuda``; raises without a card unless ``device="cpu"``)."""

    def __init__(self, params: Mapping, cfg: SuperGlueConfig = SuperGlueConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        p = superglue_params_from_numpy(params)
        names = ["kenc1", "kenc2", "final"] + [
            f"{kind}{layer}/{d}" for layer in range(cfg.num_layers)
            for kind in ("self", "cross") for d in _ATTN]
        for name in names:
            node = p
            for part in name.split("/"):
                node = node[part]
            tag = name.replace("/", "_")
            self.register_buffer(tag + "_w", to_f32(node["w"], self.device))
            self.register_buffer(tag + "_b", to_f32(node["b"], self.device))
        self.register_buffer("dustbin", to_f32(p["dustbin"], self.device))
        self.calls = 0   # logP evaluations (matches and loop candidates)

    def _dense(self, x, name):
        return x @ getattr(self, name + "_w") + getattr(self, name + "_b")

    def _attention(self, x, src, layer: str, src_mask):
        D = x.shape[-1]
        H = self.cfg.num_heads
        dh = D // H
        q = self._dense(x, layer + "_q").reshape(-1, H, dh).transpose(0, 1)     # [H, n, dh]
        k = self._dense(src, layer + "_k").reshape(-1, H, dh).transpose(0, 1)   # [H, m, dh]
        v = self._dense(src, layer + "_v").reshape(-1, H, dh).transpose(0, 1)
        logits = (q @ k.transpose(1, 2)) / math.sqrt(dh)
        logits = logits.masked_fill(~src_mask[None, None, :], _MASKED)
        msg = (torch.softmax(logits, dim=-1) @ v).transpose(0, 1).reshape(-1, D)
        h = torch.relu(self._dense(torch.cat([x, msg], dim=-1), layer + "_mlp1"))
        return x + self._dense(h, layer + "_mlp2")

    def _t(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=self.device).to(dtype)

    def logP(self, kpts_a, desc_a, scores_a, valid_a, kpts_b, desc_b, scores_b, valid_b,
             img_hw: Tuple[int, int]) -> torch.Tensor:
        """Full log-assignment matrix [N+1, M+1] with the dustbin row and
        column (numpy or tensor inputs; the result on the module's
        device)."""
        self.calls += 1
        kpts_a, desc_a, scores_a = self._t(kpts_a), self._t(desc_a), self._t(scores_a)
        kpts_b, desc_b, scores_b = self._t(kpts_b), self._t(desc_b), self._t(scores_b)
        valid_a, valid_b = self._t(valid_a, torch.bool), self._t(valid_b, torch.bool)
        Hh, Ww = img_hw
        scale = kpts_a.new_tensor([Ww, Hh])

        def encode(kpts, desc, scores):
            pos = torch.cat([kpts / scale - 0.5, scores[:, None]], dim=-1)
            return desc + self._dense(torch.relu(self._dense(pos, "kenc1")), "kenc2")

        xa = encode(kpts_a, desc_a, scores_a)
        xb = encode(kpts_b, desc_b, scores_b)
        for layer in range(self.cfg.num_layers):
            s, c = f"self{layer}", f"cross{layer}"
            xa = self._attention(xa, xa, s, valid_a)
            xb = self._attention(xb, xb, s, valid_b)
            xa, xb = self._attention(xa, xb, c, valid_b), self._attention(xb, xa, c, valid_a)
        fa = self._dense(xa, "final")
        fb = self._dense(xb, "final")
        sim = (fa @ fb.T) / math.sqrt(fa.shape[-1])
        sim = sim.masked_fill(~(valid_a[:, None] & valid_b[None, :]), _MASKED)
        return log_sinkhorn(sim, self.dustbin, self.cfg.sinkhorn_iters)

    @torch.no_grad()
    def match(self, kpts_a, desc_a, scores_a, valid_a, kpts_b, desc_b, scores_b, valid_b,
              img_hw: Tuple[int, int]):
        """Match set a into set b: ``idx`` [N] int (into b) and ``ok`` [N]
        bool, as host numpy. A match is mutual (the first index wins a
        tie, as ``jnp.argmax``), above ``match_threshold`` and valid."""
        N, M = len(kpts_a), len(kpts_b)
        if N == 0 or M == 0:
            return np.zeros(N, np.int64), np.zeros(N, bool)
        P = self.logP(kpts_a, desc_a, scores_a, valid_a, kpts_b, desc_b, scores_b, valid_b,
                      img_hw)
        Pm = torch.exp(P[:N, :M])
        pmax, idx = torch.max(Pm, dim=1)
        back = torch.argmax(Pm, dim=0)
        ok = ((back[idx] == torch.arange(N, device=Pm.device))
              & (pmax > self.cfg.match_threshold) & self._t(valid_a, torch.bool))
        return idx.cpu().numpy(), ok.cpu().numpy()


def _as_model(params, cfg: Optional[SuperGlueConfig], device) -> SuperGlue:
    if isinstance(params, SuperGlue):
        return params
    return SuperGlue(params, cfg or SuperGlueConfig(), device=device)


def make_tracker_matcher(params, img_hw: Tuple[int, int],
                         cfg: Optional[SuperGlueConfig] = None, device=None):
    """SuperGlue as the ``FeatureTracker``'s ``matcher_fn`` (reference
    enable_superglue_local): ``f(desc_a, pts_a, valid_a, desc_b, pts_b,
    valid_b) -> (idx [Na], ok [Na])``, scores of one. ``params``: a
    ``SuperGlue`` or the JAX layout (then built with ``cfg`` on
    ``device``)."""
    model = _as_model(params, cfg, device)

    def match(desc_a, pts_a, valid_a, desc_b, pts_b, valid_b):
        ones_a = torch.ones(len(pts_a), device=model.device)
        ones_b = torch.ones(len(pts_b), device=model.device)
        return model.match(pts_a, desc_a, ones_a, valid_a, pts_b, desc_b, ones_b, valid_b,
                           img_hw)

    match.model = model
    return match


def make_loop_matcher(params, cfg: Optional[SuperGlueConfig] = None, device=None):
    """SuperGlue as the ``LoopDetector``'s ``matcher_fn`` (reference
    enable_superglue_remote). Loop entries carry unit rays, not pixels:
    the positional encoding takes the rays' xy + 1 in a (2, 2) box."""
    model = _as_model(params, cfg, device)

    def match(desc_a, rays_a, valid_a, desc_b, rays_b, valid_b):
        pa = model._t(rays_a)[:, :2] + 1.0
        pb = model._t(rays_b)[:, :2] + 1.0
        ones_a = torch.ones(len(pa), device=model.device)
        ones_b = torch.ones(len(pb), device=model.device)
        return model.match(pa, desc_a, ones_a, valid_a, pb, desc_b, ones_b, valid_b, (2, 2))

    match.model = model
    return match
