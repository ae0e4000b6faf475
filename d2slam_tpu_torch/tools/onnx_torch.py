"""Execute ONNX graphs with PyTorch on the device.

Counterpart of ``d2slam_tpu/tools/onnx_jax.py``. Where the reference
runs its learned models (SuperPoint, MobileNetVLAD, SuperGlue, HitNet)
through TensorRT engines or ONNXRuntime sessions (reference:
d2frontend/src/CNN/superpoint_tensorrt.cpp,
d2frontend/include/d2frontend/CNN/onnx_generic.h,
quadcam_depth_est/include/hitnet.hpp), this module loads the same .onnx
files and runs them op by op as torch calls on the graph's device.

Design (the JAX runner's):
- float initializers become device tensors (the ``params`` dict);
- shape-carrying values (``Shape`` outputs, ``Reshape`` / ``Slice``
  targets, index constants) are folded on the host in numpy, so the
  device never syncs for a shape;
- data-dependent ops (``GatherND`` on disparity hypotheses, ``ArgMin``,
  ...) run as ordinary tensor ops.

Padding is explicit: ``F.conv*`` and the pools pad symmetrically, so
asymmetric and ``auto_pad`` pads are applied first (``-inf`` for max
pooling). ``Resize`` follows the JAX runner's per-axis index gathers.
Float32 graphs run with cuDNN's TF32 off (``cudnn_fp32``), so the card
and the CPU compute the same float32 network.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from d2slam_tpu_torch.tools.onnx_io import _DTYPES, OnnxGraph, OnnxNode, load_onnx
from d2slam_tpu_torch.utils.device import cudnn_fp32, resolve_device

# Ops safe to constant-fold on host when every input is statically known.
_FOLDABLE = {
    "Shape", "Gather", "Slice", "Concat", "Unsqueeze", "Squeeze", "Cast",
    "Add", "Sub", "Mul", "Div", "ConstantOfShape", "Range", "Floor",
    "Ceil", "Expand", "Tile", "Transpose", "Reshape", "ReduceProd",
    "Min", "Max", "Identity", "Constant", "Where", "Equal", "Neg",
    "Split",
}

_MAX_FOLD_SIZE = 1 << 16
_FLOATS = (np.float32, np.float16, np.float64)


def _ints(v, default=None):
    if v is None:
        return default
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    return tuple(int(x) for x in np.asarray(v).reshape(-1))


def _attr_str(node: OnnxNode, name: str, default: bytes) -> str:
    v = node.attr(name, default)
    return v.decode() if isinstance(v, bytes) else v


def _conv_pads(node: OnnxNode, nsp: int, in_sp, k_sp, strides, dilations):
    """Resolve ONNX Conv/Pool padding attrs to [(lo, hi)] pairs."""
    auto = _attr_str(node, "auto_pad", b"NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        pads = []
        for i in range(nsp):
            out = -(-in_sp[i] // strides[i])
            eff_k = (k_sp[i] - 1) * dilations[i] + 1
            total = max(0, (out - 1) * strides[i] + eff_k - in_sp[i])
            lo = total // 2
            hi = total - lo
            pads.append((hi, lo) if auto == "SAME_LOWER" else (lo, hi))
        return pads
    if auto == "VALID":
        return [(0, 0)] * nsp
    p = _ints(node.attr("pads"), (0,) * (2 * nsp))
    return [(p[i], p[i + nsp]) for i in range(nsp)]


def _torch_dtype(onnx_code: int) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, _DTYPES[onnx_code])).dtype


def _pad_spatial(x, pads, value=0.0):
    """Pad the trailing ``len(pads)`` dims by [(lo, hi)] pairs."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


class OnnxRunner:
    """Runs an OnnxGraph as a function of (params, *inputs) on the
    device of ``params``."""

    def __init__(self, graph: OnnxGraph, dtype=torch.float32, device=None):
        self.graph = graph
        self.dtype = dtype
        self.device = resolve_device(device)
        self.params: Dict[str, torch.Tensor] = {}
        self.const: Dict[str, np.ndarray] = {}
        self._dev_const: Dict[str, torch.Tensor] = {}
        for name, arr in graph.initializers.items():
            self.const[name] = np.asarray(arr)
            if arr.dtype in _FLOATS:
                self.params[name] = torch.as_tensor(
                    arr.astype(np.float32)).to(self.device, dtype)

    # -- static lookup helpers ------------------------------------------
    def _static(self, env, name: str) -> np.ndarray:
        if name in self.const:
            return self.const[name]
        v = env.get(name)
        if isinstance(v, np.ndarray):
            return v
        raise ValueError(
            f"ONNX value '{name}' must be statically known (got a device tensor)")

    def _get(self, env, params, name: str):
        if name == "":
            return None
        if name in env:
            v = env[name]
            return torch.as_tensor(v).to(self.device) if isinstance(v, np.ndarray) else v
        if name in params:
            return params[name]
        if name in self.const:
            t = self._dev_const.get(name)
            if t is None:
                c = self.const[name]
                t = (torch.as_tensor(c.astype(np.float32)).to(self.device, self.dtype)
                     if c.dtype in _FLOATS else torch.as_tensor(c).to(self.device))
                self._dev_const[name] = t
            return t
        raise KeyError(f"ONNX value '{name}' not found")

    def _maybe_fold(self, env, node: OnnxNode) -> bool:
        if node.op_type not in _FOLDABLE:
            return False
        vals = []
        for name in node.inputs:
            if name == "":
                vals.append(None)
                continue
            if name in self.const:
                vals.append(self.const[name])
            elif isinstance(env.get(name), np.ndarray):
                vals.append(env[name])
            else:
                return False
        try:
            outs = self._fold_op(node, vals)
        except Exception:   # not foldable on the host: run it on the device
            return False
        if any(o is None or o.size > _MAX_FOLD_SIZE for o in outs):
            return False
        for name, o in zip(node.outputs, outs):
            env[name] = np.asarray(o)
        return True

    # -- host constant folding ------------------------------------------
    def _fold_op(self, node: OnnxNode, vals) -> List[np.ndarray]:
        op = node.op_type
        x = vals[0] if vals else None
        if op == "Shape":
            return [np.asarray(x.shape, dtype=np.int64)]
        if op == "Constant":
            return [np.asarray(node.attr("value"))]
        if op == "ConstantOfShape":
            v = node.attr("value")
            fill = np.asarray(v).reshape(-1)[0] if v is not None else np.float32(0)
            return [np.full(tuple(int(d) for d in x), fill)]
        if op == "Gather":
            axis = int(node.attr("axis", 0))
            return [np.take(x, vals[1].astype(np.int64), axis=axis)]
        if op == "Slice":
            return [self._slice_np(node, vals)]
        if op == "Concat":
            return [np.concatenate(list(vals), axis=int(node.attr("axis", 0)))]
        if op == "Unsqueeze":
            axes = _ints(node.attr("axes")) or _ints(vals[1])
            y = x
            for a in sorted(axes):
                y = np.expand_dims(y, a)
            return [y]
        if op == "Squeeze":
            axes = _ints(node.attr("axes"))
            if axes is None and len(vals) > 1 and vals[1] is not None:
                axes = _ints(vals[1])
            return [np.squeeze(x, axis=tuple(axes) if axes else None)]
        if op == "Cast":
            return [x.astype(_DTYPES[int(node.attr("to"))])]
        if op == "Add":
            return [vals[0] + vals[1]]
        if op == "Sub":
            return [vals[0] - vals[1]]
        if op == "Mul":
            return [vals[0] * vals[1]]
        if op == "Div":
            y = vals[0] / vals[1]
            if np.issubdtype(vals[0].dtype, np.integer) and np.issubdtype(
                    vals[1].dtype, np.integer):
                y = (vals[0] // vals[1]).astype(vals[0].dtype)
            return [y]
        if op == "Range":
            return [np.arange(vals[0], vals[1], vals[2])]
        if op == "Floor":
            return [np.floor(x)]
        if op == "Ceil":
            return [np.ceil(x)]
        if op == "Expand":
            return [np.broadcast_to(x, _bidir_shape(x.shape, _ints(vals[1])))]
        if op == "Tile":
            return [np.tile(x, _ints(vals[1]))]
        if op == "Transpose":
            return [np.transpose(x, _ints(node.attr("perm"), tuple(range(x.ndim))[::-1]))]
        if op == "Reshape":
            return [x.reshape(_reshape_dims(x.shape, _ints(vals[1])))]
        if op == "ReduceProd":
            axes = _ints(node.attr("axes"))
            return [np.prod(x, axis=axes, keepdims=bool(node.attr("keepdims", 1)))]
        if op in ("Min", "Max"):
            fn = np.minimum if op == "Min" else np.maximum
            y = vals[0]
            for v in vals[1:]:
                y = fn(y, v)
            return [y]
        if op == "Identity":
            return [x]
        if op == "Where":
            return [np.where(vals[0], vals[1], vals[2])]
        if op == "Equal":
            return [vals[0] == vals[1]]
        if op == "Neg":
            return [-x]
        if op == "Split":
            axis = int(node.attr("axis", 0))
            splits = _ints(node.attr("split"))
            if splits is None and len(vals) > 1 and vals[1] is not None:
                splits = _ints(vals[1])
            if splits is None:
                return list(np.split(x, len(node.outputs), axis=axis))
            return list(np.split(x, np.cumsum(splits)[:-1], axis=axis))
        raise NotImplementedError(op)

    @staticmethod
    def _slice_args(node: OnnxNode, static, n_inputs):
        if n_inputs > 1 and node.inputs[1]:  # opset >= 10
            starts = _ints(static(1))
            ends = _ints(static(2))
            axes = (_ints(static(3)) if n_inputs > 3 and node.inputs[3]
                    else tuple(range(len(starts))))
            steps = (_ints(static(4)) if n_inputs > 4 and node.inputs[4]
                     else (1,) * len(starts))
        else:  # opset 1
            starts = _ints(node.attr("starts"))
            ends = _ints(node.attr("ends"))
            axes = _ints(node.attr("axes"), tuple(range(len(starts))))
            steps = (1,) * len(starts)
        return [(a, slice(None if s == -(1 << 63) else s,
                          None if e >= (1 << 62) or e == (1 << 63) - 1 else e, st))
                for s, e, a, st in zip(starts, ends, axes, steps)]

    def _slice_np(self, node: OnnxNode, vals):
        x = vals[0]
        sl = [slice(None)] * x.ndim
        for a, s in self._slice_args(node, lambda i: vals[i], len(vals)):
            sl[a % x.ndim] = s
        return x[tuple(sl)]

    # -- execution --------------------------------------------------------
    def __call__(self, params, *inputs, return_env: bool = False):
        """Run the graph. With return_env=True also returns the full
        name->value environment (every node output): the quantization
        calibrator observes activation ranges there."""
        env: Dict[str, object] = {}
        for (name, _), x in zip(self.graph.inputs, inputs):
            env[name] = x
        with cudnn_fp32():
            for node in self.graph.nodes:
                if self._maybe_fold(env, node):
                    continue
                self._exec_node(env, params, node)
        outs = [self._get(env, params, n) for n in self.graph.outputs]
        out = outs[0] if len(outs) == 1 else tuple(outs)
        return (out, env) if return_env else out

    def _exec_node(self, env, params, node: OnnxNode):
        op = node.op_type
        n_in = len(node.inputs)

        def get(i):
            return self._get(env, params, node.inputs[i]) if i < n_in else None

        def static(i):
            return self._static(env, node.inputs[i])

        def has(i):
            return n_in > i and bool(node.inputs[i])

        def put(*ys):
            for name, y in zip(node.outputs, ys):
                env[name] = y

        unary = {
            "Relu": F.relu, "Sigmoid": torch.sigmoid, "Tanh": torch.tanh,
            "Softplus": F.softplus, "Erf": torch.erf, "Exp": torch.exp,
            "Log": torch.log, "Sqrt": torch.sqrt, "Abs": torch.abs,
            "Neg": torch.neg, "Floor": torch.floor, "Ceil": torch.ceil,
            "Reciprocal": torch.reciprocal, "Not": torch.logical_not,
        }
        binary = {
            "Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
            "Div": torch.true_divide, "Pow": torch.pow,
            "Equal": torch.eq, "Greater": torch.gt, "Less": torch.lt,
            "GreaterOrEqual": torch.ge, "LessOrEqual": torch.le,
            "And": torch.logical_and, "Or": torch.logical_or,
        }
        if op in ("Conv", "ConvTranspose"):
            put(self._conv(env, params, node, transpose=(op == "ConvTranspose")))
        elif op in unary:
            put(unary[op](get(0)))
        elif op in binary:
            put(binary[op](get(0), get(1)))
        elif op == "LeakyRelu":
            put(F.leaky_relu(get(0), float(node.attr("alpha", 0.01))))
        elif op == "Elu":
            put(F.elu(get(0), float(node.attr("alpha", 1.0))))
        elif op == "PRelu":
            x, s = get(0), get(1)
            put(torch.where(x >= 0, x, x * s))
        elif op == "Softmax":
            put(torch.softmax(get(0), dim=int(node.attr("axis", -1))))
        elif op in ("Min", "Max"):
            fn = torch.minimum if op == "Min" else torch.maximum
            y = get(0)
            for i in range(1, n_in):
                y = fn(y, get(i))
            put(y)
        elif op == "Clip":
            lo = get(1) if has(1) else node.attr("min")
            hi = get(2) if has(2) else node.attr("max")
            put(torch.clamp(get(0), lo, hi))
        elif op == "Where":
            put(torch.where(get(0).bool(), get(1), get(2)))
        elif op == "Cast":
            put(get(0).to(_torch_dtype(int(node.attr("to")))))
        elif op in ("Identity", "Dropout"):
            put(get(0))
        elif op == "Concat":
            put(torch.cat([get(i) for i in range(n_in)], dim=int(node.attr("axis", 0))))
        elif op == "Reshape":
            x = get(0)
            put(x.reshape(_reshape_dims(x.shape, _ints(static(1)))))
        elif op == "Flatten":
            axis = int(node.attr("axis", 1))
            x = get(0)
            lead = int(np.prod(x.shape[:axis])) if axis else 1
            put(x.reshape(lead, -1))
        elif op == "Transpose":
            x = get(0)
            put(x.permute(_ints(node.attr("perm"), tuple(range(x.dim()))[::-1])))
        elif op == "Unsqueeze":
            axes = _ints(node.attr("axes"))
            if axes is None:
                axes = _ints(static(1))
            y = get(0)
            for a in sorted(axes):
                y = y.unsqueeze(a)
            put(y)
        elif op == "Squeeze":
            axes = _ints(node.attr("axes"))
            if axes is None and n_in > 1:
                axes = _ints(static(1))
            x = get(0)
            put(x.squeeze(tuple(a % x.dim() for a in axes)) if axes else x.squeeze())
        elif op == "Slice":
            x = get(0)
            for a, s in self._slice_args(node, static, n_in):
                x = _slice_axis(x, a % x.dim(), s)
            put(x)
        elif op == "Split":
            axis = int(node.attr("axis", 0))
            splits = _ints(node.attr("split"))
            if splits is None and n_in > 1:
                splits = _ints(static(1))
            x = get(0)
            if splits is None:
                put(*torch.tensor_split(x, len(node.outputs), dim=axis))
            else:
                put(*torch.split(x, list(splits), dim=axis))
        elif op == "Pad":
            put(self._pad(env, params, node))
        elif op == "Tile":
            put(torch.tile(get(0), _ints(static(1))))
        elif op == "Expand":
            x = get(0)
            put(torch.broadcast_to(x, _bidir_shape(x.shape, _ints(static(1)))))
        elif op == "Gather":
            x = get(0)
            axis = int(node.attr("axis", 0)) % x.dim()
            idx = _wrap(get(1).long(), x.shape[axis])
            put(torch.index_select(x, axis, idx.reshape(-1)).reshape(
                x.shape[:axis] + idx.shape + x.shape[axis + 1:]))
        elif op == "GatherElements":
            x = get(0)
            axis = int(node.attr("axis", 0)) % x.dim()
            put(torch.gather(x, axis, _wrap(get(1).long(), x.shape[axis])))
        elif op == "GatherND":
            put(_gather_nd(get(0), get(1).long(), int(node.attr("batch_dims", 0))))
        elif op == "ScatterND":
            data, idx, upd = get(0), get(1).long(), get(2)
            out = data.clone()
            out[tuple(idx.unbind(-1))] = upd
            put(out)
        elif op in ("ReduceSum", "ReduceMean", "ReduceMax", "ReduceMin",
                    "ReduceProd", "ReduceL2"):
            put(self._reduce(node, get(0), static, has))
        elif op in ("ArgMin", "ArgMax"):
            x = get(0)
            axis = int(node.attr("axis", 0))
            fn = torch.argmin if op == "ArgMin" else torch.argmax
            put(fn(x, dim=axis, keepdim=bool(node.attr("keepdims", 1))).long())
        elif op == "MatMul":
            put(torch.matmul(get(0), get(1)))
        elif op == "Gemm":
            a, b = get(0), get(1)
            if int(node.attr("transA", 0)):
                a = a.T
            if int(node.attr("transB", 0)):
                b = b.T
            y = torch.matmul(a, b) * float(node.attr("alpha", 1.0))
            if has(2):
                y = y + float(node.attr("beta", 1.0)) * get(2)
            put(y)
        elif op == "BatchNormalization":
            x, s, b, m, v = (get(i) for i in range(5))
            eps = float(node.attr("epsilon", 1e-5))
            shape = (1, -1) + (1,) * (x.dim() - 2)
            put((x - m.reshape(shape)) * (s.reshape(shape) * torch.rsqrt(v.reshape(shape) + eps))
                + b.reshape(shape))
        elif op == "InstanceNormalization":
            x, s, b = get(0), get(1), get(2)
            eps = float(node.attr("epsilon", 1e-5))
            ax = tuple(range(2, x.dim()))
            m = x.mean(dim=ax, keepdim=True)
            v = x.var(dim=ax, keepdim=True, unbiased=False)
            shape = (1, -1) + (1,) * (x.dim() - 2)
            put((x - m) * torch.rsqrt(v + eps) * s.reshape(shape) + b.reshape(shape))
        elif op in ("MaxPool", "AveragePool"):
            put(self._pool(node, get(0), op))
        elif op in ("GlobalAveragePool", "GlobalMaxPool"):
            x = get(0)
            ax = tuple(range(2, x.dim()))
            put(x.mean(dim=ax, keepdim=True) if op == "GlobalAveragePool"
                else x.amax(dim=ax, keepdim=True))
        elif op in ("Resize", "Upsample"):
            put(self._resize(env, params, node))
        elif op == "Shape":
            env[node.outputs[0]] = np.asarray(tuple(get(0).shape), dtype=np.int64)
        elif op == "ConstantOfShape":
            v = node.attr("value")
            fill = np.asarray(v).reshape(-1)[0] if v is not None else np.float32(0)
            env[node.outputs[0]] = np.full(tuple(int(d) for d in static(0)), fill)
        elif op == "Constant":
            env[node.outputs[0]] = np.asarray(node.attr("value"))
        elif op == "Einsum":
            put(torch.einsum(node.attr("equation").decode(), *[get(i) for i in range(n_in)]))
        elif op == "TopK":
            x = get(0)
            k = int(np.asarray(static(1)).reshape(-1)[0])
            axis = int(node.attr("axis", -1)) % x.dim()
            vals, idx = torch.topk(x, k, dim=axis, largest=bool(node.attr("largest", 1)),
                                   sorted=True)
            put(vals, idx.long())
        else:
            raise NotImplementedError(f"ONNX op {op} (node {node.name})")

    def _reduce(self, node, x, static, has):
        op = node.op_type
        axes = _ints(node.attr("axes"))
        if axes is None and has(1):
            axes = _ints(static(1))
        keep = bool(node.attr("keepdims", 1))
        axes = tuple(a % x.dim() for a in axes) if axes else tuple(range(x.dim()))
        if op == "ReduceL2":
            return torch.sqrt(torch.sum(x * x, dim=axes, keepdim=keep))
        if op == "ReduceProd":
            for a in sorted(axes, reverse=True):
                x = torch.prod(x, dim=a, keepdim=keep)
            return x
        fn = {"ReduceSum": torch.sum, "ReduceMean": torch.mean,
              "ReduceMax": torch.amax, "ReduceMin": torch.amin}[op]
        return fn(x, dim=axes, keepdim=keep)

    def _conv(self, env, params, node, transpose: bool):
        x = self._get(env, params, node.inputs[0])
        w = self._get(env, params, node.inputs[1])
        b = (self._get(env, params, node.inputs[2])
             if len(node.inputs) > 2 and node.inputs[2] else None)
        nsp = x.dim() - 2
        strides = _ints(node.attr("strides"), (1,) * nsp)
        dilations = _ints(node.attr("dilations"), (1,) * nsp)
        group = int(node.attr("group", 1))
        k_sp = tuple(w.shape[2:])
        if not transpose:
            pads = _conv_pads(node, nsp, tuple(x.shape[2:]), k_sp, strides, dilations)
            conv = (F.conv1d, F.conv2d, F.conv3d)[nsp - 1]
            y = conv(_pad_spatial(x, pads), w, None, strides, 0, dilations, group)
        else:
            # ConvTranspose: weight layout is (Cin, Cout/group, *k); the
            # unpadded transpose, then the pads cropped and output_padding
            # appended (zeros where no input reaches)
            out_pad = _ints(node.attr("output_padding"), (0,) * nsp)
            p = _ints(node.attr("pads"), (0,) * (2 * nsp))
            conv_t = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[nsp - 1]
            y = conv_t(x, w, None, strides, 0, 0, group, dilations)
            y = _pad_spatial(y, [(-p[i], out_pad[i] - p[i + nsp]) for i in range(nsp)])
        if b is not None:
            y = y + b.reshape((1, -1) + (1,) * nsp)
        return y

    def _pool(self, node, x, op):
        nsp = x.dim() - 2
        k = _ints(node.attr("kernel_shape"))
        strides = _ints(node.attr("strides"), (1,) * nsp)
        pads = _conv_pads(node, nsp, tuple(x.shape[2:]), k, strides, (1,) * nsp)
        if op == "MaxPool":
            pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nsp - 1]
            return pool(_pad_spatial(x, pads, -float("inf")), k, strides)
        pool = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[nsp - 1]
        kk = float(np.prod(k))
        s = pool(_pad_spatial(x, pads), k, strides) * kk
        if bool(node.attr("count_include_pad", 0)):
            return s / kk
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
        cnt = pool(_pad_spatial(ones, pads), k, strides) * kk
        return s / cnt

    def _pad(self, env, params, node):
        x = self._get(env, params, node.inputs[0])
        mode = _attr_str(node, "mode", b"constant")
        if len(node.inputs) > 1 and node.inputs[1]:
            p = _ints(self._static(env, node.inputs[1]))
        else:
            p = _ints(node.attr("pads"))
        n = x.dim()
        pairs = [(p[i], p[i + n]) for i in range(n)]
        if mode == "constant":
            cval = 0.0
            if len(node.inputs) > 2 and node.inputs[2]:
                cval = float(np.asarray(self._static(env, node.inputs[2])).reshape(-1)[0])
            return _pad_spatial(x, pairs, cval)
        np_mode = {"reflect": "reflect", "edge": "edge"}[mode]
        for axis, (lo, hi) in enumerate(pairs):
            if lo or hi:
                idx = np.pad(np.arange(x.shape[axis]), (lo, hi), mode=np_mode)
                x = torch.index_select(x, axis, torch.as_tensor(idx, device=x.device))
        return x

    def _resize(self, env, params, node):
        x = self._get(env, params, node.inputs[0])
        mode = _attr_str(node, "mode", b"nearest")
        ctm = _attr_str(node, "coordinate_transformation_mode", b"half_pixel")
        nmode = _attr_str(node, "nearest_mode", b"round_prefer_floor")
        if node.op_type == "Upsample":
            ctm = "asymmetric"  # opset-9 Upsample semantics
        out_shape = None
        if node.op_type == "Upsample" or (len(node.inputs) >= 3 and node.inputs[2]):
            sc_name = node.inputs[1 if node.op_type == "Upsample" else 2]
            scales = np.asarray(self._static(env, sc_name), dtype=np.float64)
            if scales.size:
                out_shape = tuple(int(round(s * d)) for s, d in zip(scales, x.shape))
        if out_shape is None and len(node.inputs) >= 4 and node.inputs[3]:
            out_shape = tuple(int(d) for d in self._static(env, node.inputs[3]))
        if mode == "cubic" and ctm != "half_pixel":
            raise NotImplementedError(f"cubic Resize with {ctm}")
        y = x
        for axis, (n_in, n_out) in enumerate(zip(x.shape, out_shape)):
            if n_in != n_out:
                y = (_cubic_axis(y, axis, n_out) if mode == "cubic"
                     else _resize_axis(y, axis, n_out, mode, ctm, nmode))
        return y


def _wrap(idx, n):
    """ONNX Gather indices may be negative (counted from the end)."""
    return torch.where(idx < 0, idx + n, idx)


def _slice_axis(x, axis, s: slice):
    if s.step is None or s.step > 0:
        sl = [slice(None)] * x.dim()
        sl[axis] = s
        return x[tuple(sl)]
    idx = np.arange(x.shape[axis])[s].copy()
    return torch.index_select(x, axis, torch.as_tensor(idx, device=x.device))


def _gather_nd(data, idx, batch_dims: int):
    if batch_dims == 0:
        return data[tuple(idx.unbind(-1))]
    bshape = data.shape[:batch_dims]
    d2 = data.reshape((-1,) + data.shape[batch_dims:])
    i2 = idx.reshape((d2.shape[0],) + idx.shape[batch_dims:])
    b = torch.arange(d2.shape[0], device=data.device).reshape(
        (-1,) + (1,) * (i2.dim() - 2))
    out = d2[(b,) + tuple(i2.unbind(-1))]
    return out.reshape(bshape + out.shape[1:])


def _resize_axis(x, axis: int, n_out: int, mode: str, ctm: str, nearest_mode: str):
    """Resample one axis with explicit ONNX coordinate semantics (the
    JAX runner's ``_resize_axis``; source indices and weights computed on
    the host)."""
    n_in = x.shape[axis]
    out_idx = np.arange(n_out, dtype=np.float64)
    scale = n_out / n_in
    if ctm in ("half_pixel", "pytorch_half_pixel"):
        src = (out_idx + 0.5) / scale - 0.5
        if ctm == "pytorch_half_pixel" and n_out <= 1:
            src = np.zeros_like(out_idx)
    elif ctm == "asymmetric":
        src = out_idx / scale
    elif ctm == "align_corners":
        src = out_idx * ((n_in - 1) / max(n_out - 1, 1))
    else:
        raise NotImplementedError(f"Resize coordinate mode {ctm}")

    def take(i):
        return torch.index_select(x, axis, torch.as_tensor(i.astype(np.int64), device=x.device))

    if mode == "nearest":
        if nearest_mode == "floor":
            idx = np.floor(src)
        elif nearest_mode == "ceil":
            idx = np.ceil(src)
        elif nearest_mode == "round_prefer_ceil":
            idx = np.floor(src + 0.5)
        else:  # round_prefer_floor
            idx = np.ceil(src - 0.5)
        return take(np.clip(idx, 0, n_in - 1))
    # linear: gather the two neighbours and blend (weights from the host)
    src = np.clip(src, 0.0, n_in - 1)
    i0 = np.clip(np.floor(src), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    shape = [1] * x.dim()
    shape[axis] = n_out
    w = torch.as_tensor((src - i0).astype(np.float32)).to(x.device, x.dtype).reshape(shape)
    return take(i0) * (1 - w) + take(i1) * w


def _cubic_axis(x, axis: int, n_out: int):
    """Half-pixel bicubic resampling of one axis as ``jax.image.resize``
    computes it (Keys kernel, a = -0.5; antialiased when shrinking;
    weights renormalized over the taps inside the image), as one weight
    matrix built on the host."""
    n_in = x.shape[axis]
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    d = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kscale
    w = ((1.5 * d - 2.5) * d) * d + 1.0
    w = np.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, w)
    w = np.where(d >= 2.0, 0.0, w)
    tot = w.sum(0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)
    wt = torch.as_tensor(w.astype(np.float32)).to(x.device, x.dtype)    # [n_in, n_out]
    return torch.movedim(torch.tensordot(torch.movedim(x, axis, -1), wt, dims=1), -1, axis)


def _reshape_dims(in_shape, dims):
    return tuple(int(in_shape[i]) if d == 0 else int(d) for i, d in enumerate(dims))


def _bidir_shape(in_shape, target):
    """ONNX Expand: numpy-style bidirectional broadcast of shapes."""
    target = tuple(int(t) for t in target)
    nd = max(len(in_shape), len(target))
    ish = (1,) * (nd - len(in_shape)) + tuple(in_shape)
    tsh = (1,) * (nd - len(target)) + target
    return tuple(max(a, b) for a, b in zip(ish, tsh))


@dataclasses.dataclass
class OnnxModule:
    """A loaded ONNX model: ``params`` (device tensors) + ``apply``."""

    runner: OnnxRunner
    input_names: List[str]
    input_shapes: List[tuple]
    output_names: List[str]

    @property
    def params(self):
        return self.runner.params

    @property
    def device(self) -> torch.device:
        return self.runner.device

    def apply(self, params, *inputs):
        return self.runner(params, *inputs)

    def __call__(self, *inputs):
        return self.runner(self.runner.params, *inputs)


def load_onnx_module(path, dtype=torch.float32, device=None) -> OnnxModule:
    """Load an OnnxModule from a .onnx path (or an OnnxGraph directly),
    its initializers on ``device`` (default ``cuda``)."""
    g = path if isinstance(path, OnnxGraph) else load_onnx(path)
    runner = OnnxRunner(g, dtype=dtype, device=device)
    return OnnxModule(
        runner=runner,
        input_names=[n for n, _ in g.inputs],
        input_shapes=[s for _, s in g.inputs],
        output_names=list(g.outputs),
    )
