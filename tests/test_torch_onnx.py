"""The port's ONNX reader/writer and lowering (``d2slam_tpu_torch/tools/
onnx_io.py``, ``onnx_torch.py``) against the JAX package's
(``d2slam_tpu/tools/onnx_io.py``, ``onnx_jax.py``) on the CPU.

- Bytes written by either package are read by the other, and the two
  writers emit the same bytes.
- Every op graph of tests/test_onnx_jax.py, and one graph per further op
  of the JAX runner's set, runs through both runners on the same inputs:
  outputs within 1e-5 (absolute and relative), integer outputs equal.
- The frontend loaders (both SuperPoint export styles, NetVLAD with PCA,
  the trained-HitNet route on a self-built 2-channel graph) against
  their JAX counterparts, 1e-5 on the outputs.
- The reference's trained HitNet exports are not in the repository; the
  cases that read them skip, as the JAX ones do."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2slam_tpu.tools import onnx_io as jio
from d2slam_tpu.tools.onnx_jax import OnnxRunner as JaxRunner
from d2slam_tpu_torch.tools import onnx_io as pio
from d2slam_tpu_torch.tools.onnx_torch import OnnxRunner, load_onnx_module
from tests.test_onnx_jax import HITNET, HITNET_Q, _mini_superpoint_graph

torch.set_num_threads(1)  # tests run one process per core (xdist)

TOL = 1e-5
A = pio.OnnxAttr
N = pio.OnnxNode


_INPUTS = {}   # id(graph) -> the inputs each op graph is run on


def _g(nodes, inits, inputs, outputs):
    g = pio.OnnxGraph(nodes=nodes, initializers=inits,
                      inputs=[(k, v.shape) for k, v in inputs.items()], outputs=outputs)
    _INPUTS[id(g)] = inputs
    return g


def _rng(seed=0):
    return np.random.RandomState(seed)


def _x(*shape, seed=0):
    return _rng(seed).randn(*shape).astype(np.float32)


def _single(op, x, **attrs):
    return _g([N(op, ["x"], ["y"], attrs={k: A(k, **v) for k, v in attrs.items()})],
              {}, {"x": x}, ["y"])


def _binary(op, a, b):
    return _g([N(op, ["a", "b"], ["y"])], {}, {"a": a, "b": b}, ["y"])


def _conv(x, w, b=None, **attrs):
    ins = ["x", "w"] + (["b"] if b is not None else [])
    init = {"w": w, **({"b": b} if b is not None else {})}
    return _g([N("Conv", ins, ["y"], attrs={k: A(k, **v) for k, v in attrs.items()})],
              init, {"x": x}, ["y"])


def _cases():
    """(id, graph, inputs) for every op graph of tests/test_onnx_jax.py and
    one per further op of the runner's set."""
    pos = np.abs(_x(2, 3, 4)) + 0.1
    x4 = _x(1, 4, 6, 7)
    c = {}
    # tests/test_onnx_jax.py's graphs
    c["conv_pads_stride"] = _conv(_x(1, 3, 16, 20), _x(5, 3, 3, 3, seed=1), _x(5, seed=2),
                                  pads=dict(ints=(1, 1, 1, 1)), strides=dict(ints=(2, 2)))
    w = np.zeros((1, 1, 2, 2), np.float32)
    w[0, 0] = 1.0
    c["conv_transpose_upsamples"] = _g(
        [N("ConvTranspose", ["x", "w"], ["y"], attrs={
            "strides": A("strides", ints=(2, 2)), "kernel_shape": A("kernel_shape", ints=(2, 2))})],
        {"w": w}, {"x": np.arange(12, dtype=np.float32).reshape(1, 1, 3, 4)}, ["y"])
    c["gather_nd"] = _g([N("GatherND", ["d", "i"], ["y"])], {},
                        {"d": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                         "i": np.array([[0, 2], [1, 0]], np.int64)}, ["y"])
    c["shape_slice_reshape_fold"] = _g(
        [N("Shape", ["x"], ["s"]), N("Slice", ["s", "st", "en"], ["s2"]),
         N("Concat", ["s2", "minus1"], ["tgt"], attrs={"axis": A("axis", i=0)}),
         N("Reshape", ["x", "tgt"], ["y"])],
        {"st": np.array([0], np.int64), "en": np.array([1], np.int64),
         "minus1": np.array([-1], np.int64)}, {"x": _x(2, 3, 4)}, ["y"])
    c["pool_and_pad"] = _g(
        [N("Pad", ["x", "p"], ["xp"]),
         N("MaxPool", ["xp"], ["y"], attrs={"kernel_shape": A("kernel_shape", ints=(2, 2)),
                                           "strides": A("strides", ints=(2, 2))})],
        {"p": np.array([0, 0, 1, 1, 0, 0, 1, 1], np.int64)},
        {"x": np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)}, ["y"])
    c["argmin_reduce"] = _g(
        [N("ArgMin", ["x"], ["a"], attrs={"axis": A("axis", i=1), "keepdims": A("keepdims", i=0)}),
         N("ReduceSum", ["x"], ["s"], attrs={"axes": A("axes", ints=(1,)),
                                             "keepdims": A("keepdims", i=0)})],
        {}, {"x": np.array([[3.0, 1.0, 2.0], [0.5, 4.0, 0.1]], np.float32)}, ["a", "s"])
    c["topk_axis"] = _g([N("TopK", ["x", "k"], ["v", "i"], attrs={"axis": A("axis", i=0)})],
                        {"k": np.array([2], np.int64)},
                        {"x": np.arange(12, dtype=np.float32).reshape(3, 4)}, ["v", "i"])
    for ctm, mode in (("asymmetric", "nearest"), ("align_corners", "linear"),
                      ("half_pixel", "linear")):
        c[f"resize_{ctm}_{mode}"] = _g(
            [N("Resize", ["x", "", "s"], ["y"], attrs={
                "mode": A("mode", s=mode.encode()),
                "coordinate_transformation_mode": A("coordinate_transformation_mode",
                                                    s=ctm.encode()),
                "nearest_mode": A("nearest_mode", s=b"floor")})],
            {"s": np.array([1, 1, 1, 2], np.float64)},
            {"x": np.arange(4, dtype=np.float32).reshape(1, 1, 1, 4)}, ["y"])
    c["netvlad_like"] = _g(
        [N("Transpose", ["image:0"], ["xc"], attrs={"perm": A("perm", ints=(0, 3, 1, 2))}),
         N("Conv", ["xc", "w"], ["f"], attrs={"pads": A("pads", ints=(1, 1, 1, 1))}),
         N("Relu", ["f"], ["fr"]), N("GlobalAveragePool", ["fr"], ["gap"]),
         N("Flatten", ["gap"], ["descriptor:0"])],
        {"w": _x(16, 1, 3, 3, seed=4)}, {"image:0": _rng(4).rand(1, 32, 32, 1).astype(np.float32)},
        ["descriptor:0"])
    # unary activations and maths
    for op in ("Relu", "Sigmoid", "Tanh", "Softplus", "Erf", "Exp", "Abs", "Neg",
               "Floor", "Ceil", "Reciprocal"):
        c[f"unary_{op}"] = _single(op, _x(2, 3, 4, seed=5))
    for op in ("Log", "Sqrt"):
        c[f"unary_{op}"] = _single(op, pos)
    c["LeakyRelu"] = _single("LeakyRelu", _x(2, 5), alpha=dict(f=0.2))
    c["Elu"] = _single("Elu", _x(2, 5), alpha=dict(f=0.7))
    c["PRelu"] = _g([N("PRelu", ["x", "s"], ["y"])], {"s": _x(1, 4, 1, 1, seed=6)},
                    {"x": x4}, ["y"])
    c["Softmax_axis1"] = _single("Softmax", _x(2, 5, 3), axis=dict(i=1))
    # binary and comparison ops
    a, b = _x(3, 4, seed=7), _x(3, 4, seed=8)
    for op in ("Add", "Sub", "Mul", "Div", "Min", "Max"):
        c[f"binary_{op}"] = _binary(op, a, b)
    c["binary_Pow"] = _binary("Pow", np.abs(a) + 0.5, b)
    for op in ("Equal", "Greater", "Less", "GreaterOrEqual", "LessOrEqual"):
        c[f"compare_{op}_where"] = _g(
            [N(op, ["a", "b"], ["m"]), N("Where", ["m", "a", "b"], ["y"])], {},
            {"a": np.round(a), "b": np.round(b)}, ["y"])
    c["logic_and_or_not"] = _g(
        [N("Greater", ["a", "b"], ["p"]), N("Less", ["a", "z"], ["q"]),
         N("And", ["p", "q"], ["r"]), N("Or", ["p", "q"], ["s"]), N("Not", ["r"], ["t"]),
         N("Cast", ["s"], ["y1"], attrs={"to": A("to", i=1)}),
         N("Cast", ["t"], ["y2"], attrs={"to": A("to", i=6)})],
        {"z": np.zeros((1,), np.float32)}, {"a": a, "b": b}, ["y1", "y2"])
    c["clip_inputs"] = _g([N("Clip", ["x", "lo", "hi"], ["y"])],
                          {"lo": np.array(-0.5, np.float32), "hi": np.array(0.7, np.float32)},
                          {"x": a}, ["y"])
    c["cast_f16_i32"] = _g([N("Cast", ["x"], ["h"], attrs={"to": A("to", i=10)}),
                            N("Cast", ["h"], ["y"], attrs={"to": A("to", i=1)}),
                            N("Cast", ["x"], ["z"], attrs={"to": A("to", i=6)})],
                           {}, {"x": a * 10}, ["y", "z"])
    c["int_div_traced"] = _binary("Div", np.array([7, -7, 9], np.int64),
                                  np.array([2, 2, 4], np.int64))
    # shape ops on device tensors
    c["concat_transpose_flatten"] = _g(
        [N("Concat", ["a", "b"], ["c"], attrs={"axis": A("axis", i=1)}),
         N("Transpose", ["c"], ["t"], attrs={"perm": A("perm", ints=(1, 0))}),
         N("Flatten", ["t"], ["y"], attrs={"axis": A("axis", i=1)})], {}, {"a": a, "b": b}, ["y"])
    c["unsqueeze_squeeze_inputs"] = _g(
        [N("Unsqueeze", ["x", "ax"], ["u"]), N("Squeeze", ["u", "ax"], ["y"])],
        {"ax": np.array([0, 3], np.int64)}, {"x": a}, ["y"])
    c["split_sizes_and_equal"] = _g(
        [N("Split", ["x", "sp"], ["p", "q"], attrs={"axis": A("axis", i=1)}),
         N("Split", ["x"], ["r", "s"], attrs={"axis": A("axis", i=1)})],
        {"sp": np.array([1, 3], np.int64)}, {"x": a}, ["p", "q", "r", "s"])
    c["tile_expand"] = _g(
        [N("Tile", ["x", "reps"], ["t"]), N("Expand", ["v", "shp"], ["e"])],
        {"reps": np.array([2, 1], np.int64), "shp": np.array([3, 4], np.int64)},
        {"x": a, "v": _x(3, 1, seed=9)}, ["t", "e"])
    c["slice_steps_traced"] = _g(
        [N("Slice", ["x", "st", "en", "ax", "stp"], ["y"])],
        {"st": np.array([-1, 0], np.int64), "en": np.array([-(1 << 62), 9], np.int64),
         "ax": np.array([0, 1], np.int64), "stp": np.array([-1, 2], np.int64)},
        {"x": _x(5, 9, seed=10)}, ["y"])
    c["gather_negative_elements_scatter"] = _g(
        [N("Gather", ["x", "gi"], ["g"], attrs={"axis": A("axis", i=1)}),
         N("GatherElements", ["x", "ei"], ["e"], attrs={"axis": A("axis", i=0)}),
         N("ScatterND", ["x", "si", "su"], ["s"])],
        {"gi": np.array([[-1, 0], [2, -3]], np.int64),
         "ei": np.array([[2, 0, 1, 1], [0, 1, 2, 0]], np.int64),
         "si": np.array([[1], [0]], np.int64), "su": _x(2, 4, seed=11)},
        {"x": _x(3, 4, seed=12)}, ["g", "e", "s"])
    c["gather_nd_batch"] = _g(
        [N("GatherND", ["d", "i"], ["y"], attrs={"batch_dims": A("batch_dims", i=1)})], {},
        {"d": _x(2, 5, 3, seed=13), "i": np.array([[[4], [0]], [[1], [1]]], np.int64)}, ["y"])
    # reductions
    for op in ("ReduceMean", "ReduceMax", "ReduceMin", "ReduceProd", "ReduceL2"):
        c[op] = _single(op, _x(2, 3, 4, seed=14), axes=dict(ints=(0, 2)), keepdims=dict(i=1))
    c["ReduceSum_axes_input_all"] = _g(
        [N("ReduceSum", ["x", "ax"], ["y"], attrs={"keepdims": A("keepdims", i=0)}),
         N("ReduceMean", ["x"], ["z"], attrs={"keepdims": A("keepdims", i=0)})],
        {"ax": np.array([-1], np.int64)}, {"x": _x(2, 3, 4, seed=14)}, ["y", "z"])
    c["ArgMax_keep"] = _single("ArgMax", _x(3, 5, seed=15), axis=dict(i=1))
    # linear algebra and normalization
    c["matmul_batched"] = _binary("MatMul", _x(2, 3, 4, seed=16), _x(4, 5, seed=17))
    c["gemm"] = _g([N("Gemm", ["a", "b", "c"], ["y"], attrs={
        "transB": A("transB", i=1), "alpha": A("alpha", f=0.5), "beta": A("beta", f=2.0)})],
        {"b": _x(5, 4, seed=18), "c": _x(5, seed=19)}, {"a": _x(3, 4, seed=20)}, ["y"])
    c["einsum"] = _g([N("Einsum", ["a", "b"], ["y"], attrs={"equation": A("equation", s=b"bij,bjk->bik")})],
                     {}, {"a": _x(2, 3, 4, seed=21), "b": _x(2, 4, 2, seed=22)}, ["y"])
    ch = 4
    c["batchnorm"] = _g([N("BatchNormalization", ["x", "s", "b", "m", "v"], ["y"])],
                        {"s": _x(ch, seed=23), "b": _x(ch, seed=24), "m": _x(ch, seed=25),
                         "v": np.abs(_x(ch, seed=26)) + 0.5}, {"x": x4}, ["y"])
    c["instancenorm"] = _g([N("InstanceNormalization", ["x", "s", "b"], ["y"])],
                           {"s": _x(ch, seed=27), "b": _x(ch, seed=28)}, {"x": x4}, ["y"])
    # pooling
    c["maxpool_same_upper"] = _single("MaxPool", x4, kernel_shape=dict(ints=(3, 3)),
                                      strides=dict(ints=(2, 2)), auto_pad=dict(s=b"SAME_UPPER"))
    for cip in (0, 1):
        c[f"avgpool_pads_cip{cip}"] = _single(
            "AveragePool", x4, kernel_shape=dict(ints=(3, 2)), strides=dict(ints=(2, 1)),
            pads=dict(ints=(1, 0, 1, 1)), count_include_pad=dict(i=cip))
    c["global_avg_max"] = _g([N("GlobalAveragePool", ["x"], ["a"]),
                              N("GlobalMaxPool", ["x"], ["m"])], {}, {"x": x4}, ["a", "m"])
    # convolutions
    c["conv_same_lower_dilated_grouped"] = _conv(
        _x(1, 4, 9, 11, seed=29), _x(6, 2, 3, 3, seed=30), _x(6, seed=31),
        auto_pad=dict(s=b"SAME_LOWER"), strides=dict(ints=(2, 2)), dilations=dict(ints=(2, 1)),
        group=dict(i=2))
    c["conv_asym_pads"] = _conv(_x(1, 2, 8, 8, seed=32), _x(3, 2, 3, 3, seed=33),
                                pads=dict(ints=(0, 1, 2, 0)), strides=dict(ints=(2, 2)))
    c["conv1d"] = _conv(_x(2, 3, 10, seed=34), _x(4, 3, 3, seed=35), _x(4, seed=36),
                        pads=dict(ints=(2, 0)))
    c["conv_transpose_pads_outpad_group"] = _g(
        [N("ConvTranspose", ["x", "w", "b"], ["y"], attrs={
            "strides": A("strides", ints=(2, 3)), "pads": A("pads", ints=(1, 0, 0, 2)),
            "output_padding": A("output_padding", ints=(1, 2)), "group": A("group", i=2)})],
        {"w": _x(4, 3, 3, 4, seed=37), "b": _x(6, seed=38)}, {"x": _x(1, 4, 5, 6, seed=39)}, ["y"])
    # padding and resampling
    for mode in ("reflect", "edge"):
        c[f"pad_{mode}"] = _g([N("Pad", ["x", "p"], ["y"], attrs={"mode": A("mode", s=mode.encode())})],
                              {"p": np.array([0, 0, 2, 1, 0, 0, 1, 3], np.int64)}, {"x": x4}, ["y"])
    c["pad_constant_value"] = _g([N("Pad", ["x", "p", "v"], ["y"])],
                                 {"p": np.array([0, 1, 0, 2, 0, 0, 3, 0], np.int64),
                                  "v": np.array([1.5], np.float32)}, {"x": x4}, ["y"])
    for name, scales, mode, nmode in (
            ("resize_cubic_up", (1, 1, 2, 1.5), b"cubic", b"floor"),
            ("resize_cubic_down", (1, 1, 0.5, 0.75), b"cubic", b"floor"),
            ("resize_nearest_prefer_ceil", (1, 1, 1.5, 2.5), b"nearest", b"round_prefer_ceil"),
            ("resize_linear_down", (1, 1, 0.5, 0.5), b"linear", b"floor")):
        c[name] = _g([N("Resize", ["x", "", "s"], ["y"], attrs={
            "mode": A("mode", s=mode), "nearest_mode": A("nearest_mode", s=nmode)})],
            {"s": np.array(scales, np.float32)}, {"x": _x(1, 2, 8, 8, seed=40)}, ["y"])
    c["resize_sizes_pytorch_half_pixel"] = _g(
        [N("Resize", ["x", "", "", "sz"], ["y"], attrs={
            "mode": A("mode", s=b"linear"),
            "coordinate_transformation_mode": A("coordinate_transformation_mode",
                                                s=b"pytorch_half_pixel")})],
        {"sz": np.array([1, 2, 13, 5], np.int64)}, {"x": _x(1, 2, 8, 8, seed=41)}, ["y"])
    c["upsample_nearest"] = _g([N("Upsample", ["x", "s"], ["y"])],
                               {"s": np.array([1, 1, 2, 2], np.float32)}, {"x": x4}, ["y"])
    # host folding chains (Range, ConstantOfShape, Constant, Gather on shapes)
    c["fold_range_constant_of_shape"] = _g(
        [N("Shape", ["x"], ["s"]), N("Gather", ["s", "i1"], ["n"]),
         N("Range", ["zero", "n", "one"], ["r"]), N("Cast", ["r"], ["rf"], attrs={"to": A("to", i=1)}),
         N("ConstantOfShape", ["s"], ["z"], attrs={"value": A("value", t=np.array([2.0], np.float32))}),
         N("Constant", [], ["k"], attrs={"value": A("value", t=np.array(3.0, np.float32))}),
         N("Mul", ["z", "k"], ["zk"]), N("Add", ["x", "zk"], ["xa"]), N("Add", ["xa", "rf"], ["y"])],
        {"i1": np.array(1, np.int64), "zero": np.array(0, np.int64), "one": np.array(1, np.int64)},
        {"x": _x(3, 4, seed=42)}, ["y"])
    return [(k, g) for k, g in c.items()]


CASES = _cases()


@pytest.mark.parametrize("case", [g for _, g in CASES], ids=[k for k, _ in CASES])
def test_op_graph_matches_jax(case):
    inputs = _INPUTS[id(case)]
    jr, pr = JaxRunner(case), OnnxRunner(case, device="cpu")
    jo = jr(jr.params, *[jnp.asarray(v) for v in inputs.values()])
    po = pr(pr.params, *[torch.as_tensor(v) for v in inputs.values()])
    jo = jo if isinstance(jo, tuple) else (jo,)
    po = po if isinstance(po, tuple) else (po,)
    assert len(jo) == len(po)
    for j, p in zip(jo, po):
        j = np.asarray(j)
        p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        assert j.shape == p.shape
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)
        else:
            np.testing.assert_array_equal(p, j)


def test_bytes_read_both_ways(tmp_path):
    """A graph with float, int64, float16 and bool initializers and every
    attribute kind: written by each package, read by the other, and the
    two writers' bytes are equal."""
    g = _g([N("Conv", ["x", "w"], ["y"], attrs={
        "pads": A("pads", ints=(1, 1, 1, 1)), "alpha": A("alpha", f=0.5),
        "mode": A("mode", s=b"edge"), "scales": A("scales", floats=(1.0, 2.5)),
        "value": A("value", t=np.array([3], np.int64)), "group": A("group", i=1)})],
        {"w": _x(4, 1, 3, 3), "shape_c": np.array([1, -4], np.int64),
         "h": np.array([1.5, -2.0], np.float16), "m": np.array([True, False])},
        {"x": np.zeros((1, 1, 8, 8), np.float32)}, ["y"])
    pio.save_onnx(g, str(tmp_path / "p.onnx"))
    jio.save_onnx(g, str(tmp_path / "j.onnx"))
    assert (tmp_path / "p.onnx").read_bytes() == (tmp_path / "j.onnx").read_bytes()
    for writer, reader in (("p", jio), ("j", pio)):
        g2 = reader.load_onnx(str(tmp_path / f"{writer}.onnx"))
        assert [n.op_type for n in g2.nodes] == ["Conv"]
        for k, v in g.initializers.items():
            assert g2.initializers[k].dtype == v.dtype
            np.testing.assert_array_equal(g2.initializers[k], v)
        a, b = g.nodes[0].attrs, g2.nodes[0].attrs
        assert a["pads"].ints == b["pads"].ints and a["alpha"].f == b["alpha"].f
        assert a["mode"].s == b["mode"].s and tuple(b["scales"].floats) == (1.0, 2.5)
        np.testing.assert_array_equal(b["value"].t, [3])
        assert g2.inputs == [("x", (1, 1, 8, 8))] and g2.outputs == ["y"]


def test_typed_fields_decode():
    """Typed (non-raw) tensor fields decode as in the JAX reader:
    negative int32 varints and fp16 bit patterns in int32_data."""
    buf = (pio._enc_field(1, 0, 2) + pio._enc_field(2, 0, 6)
           + pio._enc_field(5, 0, -5) + pio._enc_field(5, 0, 7))
    for mod in (pio, jio):
        _, arr = mod._decode_tensor(buf)
        np.testing.assert_array_equal(arr, [-5, 7])
        assert arr.dtype == np.int32
    buf = pio._enc_field(1, 0, 1) + pio._enc_field(2, 0, 10) + pio._enc_field(5, 0, 0x3E00)
    _, arr = pio._decode_tensor(buf)
    assert arr.dtype == np.float16 and float(arr.reshape(-1)[0]) == 1.5


@pytest.mark.parametrize("style", ["heatmap", "logits"])
def test_superpoint_from_onnx_matches_jax(tmp_path, style):
    from d2slam_tpu.frontend import superpoint as jsp
    from d2slam_tpu_torch.frontend import superpoint as psp

    p = str(tmp_path / f"sp_{style}.onnx")
    jio.save_onnx(_mini_superpoint_graph(style), p)
    img = np.random.RandomState(3).rand(2, 64, 64).astype(np.float32)
    apply_fn, params = jsp.superpoint_from_onnx(p)
    js, jd = apply_fn(params, jnp.asarray(img)[..., None])
    model = psp.superpoint_from_onnx(p, psp.SuperPointConfig(max_keypoints=16, threshold=-1.0),
                                     device="cpu")
    ps, pd = psp.superpoint_apply(model, torch.as_tensor(img)[..., None])
    assert ps.shape == (2, 64, 64) and pd.shape == (2, 8, 8, 32)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)
    cfg = jsp.SuperPointConfig(max_keypoints=16, threshold=-1.0)
    jo = jsp.superpoint_extract(params, jnp.asarray(img[0]), cfg, apply_fn=apply_fn)
    po = psp.superpoint_extract(model, torch.as_tensor(img[:1]))
    assert po.kpts.shape == (1, 16, 2) and bool(po.valid.all())
    np.testing.assert_allclose(po.kpts[0].numpy(), np.asarray(jo.kpts), atol=1e-4)
    np.testing.assert_allclose(po.desc[0].numpy(), np.asarray(jo.desc), atol=1e-4)


def test_netvlad_from_onnx_with_pca_matches_jax(tmp_path):
    from d2slam_tpu.frontend.netvlad import netvlad_from_onnx as jnv
    from d2slam_tpu_torch.frontend.netvlad import netvlad_from_onnx as pnv

    g = dict(CASES)["netvlad_like"]
    p = str(tmp_path / "nv.onnx")
    pio.save_onnx(g, p)
    rng = np.random.RandomState(4)
    pca = (rng.randn(16).astype(np.float32) * 0.1, rng.randn(16, 4).astype(np.float32))
    img = rng.rand(2, 32, 32).astype(np.float32)
    apply_fn, params = jnv(p, pca=pca)
    ref = np.asarray(apply_fn(params, jnp.asarray(img)[..., None]))
    model = pnv(p, pca=pca, device="cpu")
    out = model(torch.as_tensor(img)).numpy()
    assert out.shape == (2, 4) and model.calls == 1
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def _hitnet_graph(H=16, W=24):
    """A 2-channel (left, right) graph in the export's interface: a
    conv, an asymmetric pad, a cost over 4 shifts, a soft argmin and a
    bilinear 2x upsample back to [1, 1, H, W]."""
    rng = _rng(5)
    nodes = [N("Conv", ["lr", "w"], ["f"], attrs={"pads": A("pads", ints=(1, 1, 1, 1)),
                                                   "strides": A("strides", ints=(2, 2))}),
             N("Split", ["f"], ["fl", "fr"], attrs={"axis": A("axis", i=1)})]
    costs = []
    for d in range(4):
        nodes += [N("Pad", ["fr", f"p{d}"], [f"fr{d}"]),
                  N("Slice", [f"fr{d}", "s0", f"e{d}", "ax3"], [f"frs{d}"]),
                  N("Sub", ["fl", f"frs{d}"], [f"df{d}"]), N("Abs", [f"df{d}"], [f"ad{d}"]),
                  N("ReduceMean", [f"ad{d}"], [f"c{d}"], attrs={"axes": A("axes", ints=(1,))})]
        costs.append(f"c{d}")
    nodes += [N("Concat", costs, ["cv"], attrs={"axis": A("axis", i=1)}),
              N("Mul", ["cv", "neg"], ["ncv"]),
              N("Softmax", ["ncv"], ["sm"], attrs={"axis": A("axis", i=1)}),
              N("Mul", ["sm", "dd"], ["wd"]),
              N("ReduceSum", ["wd"], ["disp"], attrs={"axes": A("axes", ints=(1,))}),
              N("Resize", ["disp", "", "sc"], ["up"], attrs={"mode": A("mode", s=b"linear")}),
              N("Mul", ["up", "two"], ["y"])]
    init = {"w": rng.randn(8, 2, 3, 3).astype(np.float32) * 0.5, "neg": np.array(-8.0, np.float32),
            "dd": np.arange(4, dtype=np.float32).reshape(1, 4, 1, 1),
            "two": np.array(2.0, np.float32), "sc": np.array([1, 1, 2, 2], np.float32),
            "s0": np.array([0], np.int64), "ax3": np.array([3], np.int64)}
    for d in range(4):
        init[f"p{d}"] = np.array([0, 0, 0, d, 0, 0, 0, 0], np.int64)
        init[f"e{d}"] = np.array([W // 2], np.int64)
    return pio.OnnxGraph(nodes=nodes, initializers=init, inputs=[("lr", (1, 2, H, W))],
                         outputs=["y"])


def test_trained_hitnet_route_matches_jax(tmp_path):
    from d2slam_tpu.depth.hitnet import load_trained_hitnet as jload
    from d2slam_tpu_torch.depth.hitnet import load_trained_hitnet as pload

    p = str(tmp_path / "hitnet_2ch.onnx")
    pio.save_onnx(_hitnet_graph(), p)
    rng = _rng(6)
    left, right = rng.rand(16, 24).astype(np.float32), rng.rand(16, 24).astype(np.float32)
    apply, params = jload(p)
    ref = np.asarray(apply(params, jnp.asarray(left), jnp.asarray(right)))
    net = pload(p, device="cpu")
    assert net.input_hw == apply.input_hw == (16, 24)
    out = net(torch.as_tensor(left), torch.as_tensor(right)).numpy()
    assert out.shape == ref.shape == (16, 24)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    with pytest.raises(FileNotFoundError, match="hitnet_1x240x320_model_float32.onnx"):
        pload(device="cpu")


def test_load_onnx_module_on_cpu_and_default_device(tmp_path):
    p = str(tmp_path / "m.onnx")
    pio.save_onnx(dict(CASES)["conv_pads_stride"], p)
    m = load_onnx_module(p, device="cpu")
    assert m.input_names == ["x"] and m.input_shapes == [(1, 3, 16, 20)]
    assert m.output_names == ["y"] and m.device.type == "cpu"
    assert all(v.dtype == torch.float32 for v in m.params.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_onnx_module(p)


@pytest.mark.slow
@pytest.mark.parametrize("path", [HITNET, HITNET_Q], ids=["float32", "float16_quant"])
def test_reference_hitnet_export(path):
    """The reference's trained exports, as tests/test_onnx_jax.py reads
    them: disparity of a synthetic 12 px shift."""
    if not os.path.exists(path):
        pytest.skip("reference HitNet onnx absent")
    from scipy import ndimage as ndi

    from d2slam_tpu_torch.depth.hitnet import load_trained_hitnet

    net = load_trained_hitnet(path, device="cpu")
    tex = ndi.gaussian_filter(_rng(0).rand(240, 400), 1.2)
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    left = torch.as_tensor(tex[:, 32:352], dtype=torch.float32)
    right = torch.as_tensor(tex[:, 44:364], dtype=torch.float32)
    inner = net(left, right).numpy()[20:-20, 40:-40]
    assert abs(np.median(inner) - 12) < 0.5


def test_convert_torch_state_dict_matches_jax():
    """The public magicleap checkpoint's layout (OIHW ``<layer>.weight``)
    to the JAX parameter layout, as the JAX package converts it; the
    port's SuperPoint built from it."""
    from d2slam_tpu.frontend import superpoint as jsp
    from d2slam_tpu_torch.frontend import superpoint as psp

    shapes = {name: p["w"].shape for name, p in psp.random_params(0).items()}
    rng = _rng(7)
    state = {}
    for name, (kh, kw, cin, cout) in shapes.items():
        state[f"{name}.weight"] = torch.as_tensor(rng.randn(cout, cin, kh, kw).astype(np.float32))
        state[f"{name}.bias"] = torch.as_tensor(rng.randn(cout).astype(np.float32))
    ours = psp.convert_torch_state_dict(state)
    ref = jsp.convert_torch_state_dict({k: v.numpy() for k, v in state.items()})
    assert set(ours) == set(ref)
    for name in ref:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(ours[name][leaf], np.asarray(ref[name][leaf]))
    model = psp.SuperPoint(ours, device="cpu")
    np.testing.assert_array_equal(model.conv1a_w.numpy(), state["conv1a.weight"].numpy())
