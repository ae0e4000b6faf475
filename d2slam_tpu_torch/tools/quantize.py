"""Post-training int8 quantization for ONNX-lowered models.

Counterpart of ``d2slam_tpu/tools/quantize.py`` (reference:
quadcam_tools/quantonnx.py — onnxruntime calibrator over sample images
producing a TensorRT int8 calibration table; the TRT engine then runs
int8). The tool produces:

  * **weight-only int8**: per-output-channel symmetric quantization of
    Conv/MatMul/Gemm initializers. The quantized parameters hold int8
    values + float scales on the device (4x smaller weights);
    ``apply`` dequantizes each weight in front of its consumer op.
  * **activation calibration table**: per-tensor absolute-max ranges
    observed while running sample batches (the calibration-table
    artifact the reference writes for TRT), JSON-serializable, used by
    ``fake_quant`` to simulate int8 activation error offline.

Usage:
    mod = load_onnx_module("hitnet.onnx")
    qmod = quantize_module(mod)                   # weight-only int8
    out = qmod.apply(qmod.qparams, x)
    table = calibrate_activations(mod, [(x1,), (x2,)])
    save_calibration_table(table, "calib.json")
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from d2slam_tpu_torch.tools.onnx_torch import OnnxModule

# ops whose (first-) weight input benefits from per-channel quantization,
# mapped to the axis that indexes output channels in the weight layout
_WEIGHT_OPS = {
    "Conv": 0,           # OIHW
    "ConvTranspose": 1,  # IOHW
    "Gemm": 0,           # transB=1 layout checked below
    "MatMul": 1,         # [K, N]: per-column
}


def quantize_array(w: np.ndarray, axis: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 quantization along ``axis``.

    Returns (q int8 same shape, scale float32 broadcastable to w) with
    w ~= q * scale. Zero channels get scale 1 (q = 0).
    """
    w = np.asarray(w, np.float32)
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.max(np.abs(w), axis=red, keepdims=True) if w.ndim else np.abs(w)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def _weight_names(module: OnnxModule, min_size: int) -> Dict[str, int]:
    """Initializer name -> output-channel axis for weights worth quantizing."""
    out = {}
    inits = module.runner.graph.initializers
    for node in module.runner.graph.nodes:
        axis = _WEIGHT_OPS.get(node.op_type)
        if axis is None or len(node.inputs) < 2:
            continue
        wname = node.inputs[1]
        w = inits.get(wname)
        if w is None or w.size < min_size or w.dtype.kind != "f":
            continue
        if node.op_type == "Gemm" and not int(node.attr("transB", 0)):
            axis = 1  # weights are [K, N] without transB
        out[wname] = axis
    return out


@dataclass
class QuantizedModule:
    """Weight-only int8 view of an OnnxModule."""

    module: OnnxModule
    qparams: Dict[str, object]       # name -> {"q": int8, "scale": float} or float tensor
    quantized: List[str]             # names stored as int8
    bytes_before: int
    bytes_after: int

    def dequantize(self, qparams=None) -> Dict[str, torch.Tensor]:
        qp = self.qparams if qparams is None else qparams
        return {name: (v["q"].to(self.module.runner.dtype) * v["scale"]
                       if isinstance(v, dict) else v) for name, v in qp.items()}

    @property
    def device(self) -> torch.device:
        return self.module.device

    def apply(self, qparams, *inputs):
        return self.module.apply(self.dequantize(qparams), *inputs)

    def __call__(self, *inputs):
        """``OnnxModule``'s call contract, so a quantized export plugs in
        where the float one does (e.g. ``OnnxSuperPoint``)."""
        return self.apply(self.qparams, *inputs)


def quantize_module(module: OnnxModule, min_size: int = 512) -> QuantizedModule:
    """Quantize every Conv/MatMul/Gemm weight of ``module`` to int8; the
    int8 values and their scales live on the module's device."""
    axes = _weight_names(module, min_size)
    dev, dtype = module.device, module.runner.dtype
    qparams: Dict[str, object] = {}
    quantized: List[str] = []
    before = after = 0
    for name, p in module.params.items():
        before += p.numel() * 4
        if name in axes:
            q, scale = quantize_array(p.float().cpu().numpy(), axes[name])
            qparams[name] = {"q": torch.as_tensor(q).to(dev),
                             "scale": torch.as_tensor(scale).to(dev, dtype)}
            quantized.append(name)
            after += q.size + scale.size * 4
        else:
            qparams[name] = p
            after += p.numel() * 4
    return QuantizedModule(module, qparams, quantized, before, after)


def _is_float(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.dtype.is_floating_point
    return isinstance(v, np.ndarray) and v.dtype.kind == "f"


def calibrate_activations(
    module: OnnxModule,
    sample_batches: Sequence[Tuple],
    percentile: float = 100.0,
) -> Dict[str, float]:
    """Observe per-tensor activation amax over sample inputs.

    Returns {tensor_name: amax} for every floating intermediate — the
    calibration table the reference writes for the TensorRT int8 engine
    (quantonnx.py write_calibration_table). ``percentile`` < 100 clips
    outliers (entropy-free percentile calibration). One read-back per
    batch: the amaxes (or the tensors, for a percentile) are stacked on
    the device first.
    """
    table: Dict[str, List[float]] = {}
    for batch in sample_batches:
        _, env = module.runner(module.params, *batch, return_env=True)
        names, vals = [], []
        for name, v in env.items():
            if not _is_float(v):
                continue
            a = torch.as_tensor(v).to(module.device).abs().reshape(-1).float()
            if a.numel() == 0:
                continue
            names.append(name)
            vals.append(a)
        if percentile >= 100.0:
            amaxes = torch.stack([a.max() for a in vals]).cpu().numpy() if vals else []
        else:
            amaxes = [float(np.percentile(a.cpu().numpy(), percentile)) for a in vals]
        for name, amax in zip(names, amaxes):
            table.setdefault(name, []).append(float(amax))
    return {k: max(v) for k, v in table.items()}


def save_calibration_table(table: Dict[str, float], path: str) -> None:
    with open(path, "w") as f:
        json.dump({"method": "amax", "ranges": table}, f, indent=1)


def load_calibration_table(path: str) -> Dict[str, float]:
    with open(path) as f:
        return json.load(f)["ranges"]


def fake_quant(x: torch.Tensor, amax: float) -> torch.Tensor:
    """Simulate int8 quantize->dequantize of an activation with range
    ``amax`` (for offline accuracy studies of the int8 path)."""
    scale = max(amax, 1e-12) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def quantization_report(module: OnnxModule, qmod: QuantizedModule,
                        sample: Tuple) -> Dict[str, float]:
    """Run both precisions on one sample batch; report size + error."""
    ref = module.apply(module.params, *sample)
    got = qmod.apply(qmod.qparams, *sample)
    refs = ref if isinstance(ref, tuple) else (ref,)
    gots = got if isinstance(got, tuple) else (got,)
    rel = max(float(torch.max(torch.abs(g - r)) / (torch.max(torch.abs(r)) + 1e-12))
              for g, r in zip(gots, refs))
    return {
        "bytes_before": qmod.bytes_before,
        "bytes_after": qmod.bytes_after,
        "compression": qmod.bytes_before / max(qmod.bytes_after, 1),
        "n_quantized": len(qmod.quantized),
        "max_rel_err": rel,
    }
