"""The port's quantized weights against the JAX package's: the int8 / int4
layouts byte for byte (training/quant.py), the plain versions of K6 and K7
against the JAX Pallas kernels in interpret mode, the row routing,
`GritLM(weight_quant=8|4)`, the serving engine and both CLIs with quantized
weights, QLoRA training, and `from_pretrained` / `--model_name_or_path` on
a checkpoint written here (no download).

Tolerances: layouts are equal byte for byte; the plain K6/K7 against the
Pallas kernels (bf16 in, bf16 out) within the JAX tests' relative Frobenius
error 5e-3, and within one bf16 ulp elementwise (the same fp32 sums in
another order round to the same or a neighbouring bf16); the model-level
checks run float32 tiny_mistral on the CPU, where greedy tokens must be
identical, embeddings at cosine >= 0.9999, and QLoRA losses within 1e-5
relative (the same sums in another order).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gritlm_tpu.ops.quant_matmul as jqm
import gritlm_tpu.rag.eval as jax_eval
import gritlm_tpu.serve as jax_serve
from gritlm_tpu.config import tiny_mistral as jax_tiny_mistral
from gritlm_tpu.gritlm import GritLM as JaxGritLM
from gritlm_tpu.models import init_params as jax_init_params
from gritlm_tpu.parallel.mesh import single_device_mesh
from gritlm_tpu.serving import Request as JaxRequest
from gritlm_tpu.serving import ServingEngine as JaxServingEngine
from gritlm_tpu.training import quant as jq
from gritlm_tpu.training import train as jt
from gritlm_tpu.training.lora import init_lora as jax_init_lora
from gritlm_tpu.training.lora import lora_train_step_fns as jax_lora_fns
from gritlm_tpu.training.lora import make_lora_train_state as jax_make_lora_train_state
from gritlm_tpu.training.lora import merge as jax_merge
from gritlm_tpu_torch import GritLM
from gritlm_tpu_torch import serve as port_serve
from gritlm_tpu_torch.config import tiny_mistral
from gritlm_tpu_torch.models.convert import lora_from_jax, params_from_jax, params_to_numpy
from gritlm_tpu_torch.models.loader import save_checkpoint
from gritlm_tpu_torch.ops import quant_matmul as qm
from gritlm_tpu_torch.rag import eval as port_eval
from gritlm_tpu_torch.serving import Request, ServingEngine
from gritlm_tpu_torch.tokenizer import ByteTokenizer
from gritlm_tpu_torch.training import quant as pq
from gritlm_tpu_torch.training import train as pt
from gritlm_tpu_torch.training.data import GritCollator
from gritlm_tpu_torch.training.lora import apply_lora_lazy, make_lora_train_state, merge
from tok_fixtures import make_bpe_tokenizer

KERNEL_RTOL = 5e-3
COS_MIN = 0.9999
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x)


def _flat(tree, path=()):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _to_f32(x) -> np.ndarray:
    """A JAX or torch array as float32 numpy (bf16 bits widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ layouts

LAYOUT_CASES = {
    "int8 2-D": ((256, 128), 8, None, jnp.float32),
    "int8 stacked": ((3, 64, 96), 8, None, jnp.float32),
    "int8 from bf16": ((128, 64), 8, None, jnp.bfloat16),
    "int4 g32 2-D": ((256, 128), 4, None, jnp.float32),
    "int4 g32 stacked": ((3, 128, 64), 4, None, jnp.float32),
    "int4 g16 explicit": ((64, 32), 4, 16, jnp.float32),
    "int4 gcd-shrunk g16": ((48, 32), 4, None, jnp.float32),
    "int4 gcd-shrunk g8, bf16": ((40, 16), 4, None, jnp.bfloat16),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_quantize_matches_jax(case):
    """quantize_kernel / quantize_kernel_int4 give the JAX package's bytes;
    unpack and dequantize (fp32 and bf16) give its values."""
    shape, bits, group, dt = LAYOUT_CASES[case]
    w = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    jw = jnp.asarray(w, dt)
    tw = torch.from_numpy(_to_f32(jw)).to(torch.bfloat16 if dt == jnp.bfloat16 else torch.float32)
    if bits == 8:
        want, got = jq.quantize_kernel(jw), pq.quantize_kernel(tw)
        key = "q8"
    else:
        want, got = jq.quantize_kernel_int4(jw, group), pq.quantize_kernel_int4(tw, group)
        key = "q4"
        np.testing.assert_array_equal(pq.unpack_int4(got)[0].numpy(), _np(jq.unpack_int4(want)[0]))
        g = shape[-2] // got["scale"].shape[-2]
        assert g == (group or math.gcd(shape[-2], 32))
    assert sorted(got) == sorted(want)
    for k in (key, "scale"):
        assert got[k].numpy().dtype == _np(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]), err_msg=k)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(_to_f32(pq.dequantize_kernel(got, tdt)),
                                      _to_f32(jq.dequantize_kernel(want, jdt)))


@pytest.fixture(scope="module")
def jparams():
    return jax_init_params(jax_tiny_mistral(), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def np_params(jparams):
    return jax.tree_util.tree_map(np.asarray, jparams)


@pytest.mark.parametrize("kind,bits", [("serving", 8), ("serving", 4), ("qlora base", 8)])
def test_quantized_trees_match_jax(jparams, np_params, kind, bits):
    """quantize_for_serving (the LM head too) and quantize_tree (the QLoRA
    base): the same tree paths, dtypes, shapes and bytes, the same
    quantized_bytes, and dequantize_tree gives the same values."""
    tparams = params_from_jax(np_params, tiny_mistral(), device="cpu")
    if kind == "serving":
        want = jq.quantize_for_serving(jparams, bits=bits)
        got = pq.quantize_for_serving(tparams, bits=bits)
    else:
        want, got = jq.quantize_tree(jparams), pq.quantize_tree(tparams)
    fw, fg = _flat(want), _flat(got)
    assert sorted(fg) == sorted(fw)
    for path, leaf in fw.items():
        g = fg[path]
        assert tuple(g.shape) == tuple(leaf.shape), path
        if leaf.dtype in (jnp.int8, jnp.uint8):
            assert g.numpy().dtype == _np(leaf).dtype, path
        np.testing.assert_array_equal(_to_f32(g), _to_f32(leaf), err_msg=str(path))
    assert pq.quantized_bytes(got) == jq.quantized_bytes(want)
    assert pq.quantized_bytes(got) < pq.quantized_bytes(tparams)
    back_w = _flat(jq.dequantize_tree(want, jnp.float32))
    back_g = _flat(pq.dequantize_tree(got, torch.float32))
    assert sorted(back_g) == sorted(back_w)
    for path, leaf in back_w.items():
        np.testing.assert_array_equal(_to_f32(back_g[path]), _to_f32(leaf), err_msg=str(path))


@pytest.mark.parametrize("bits", [8, 4])
def test_params_from_jax_carries_quantized_trees(jparams, bits):
    """A JAX-quantized tree crosses with params_from_jax byte for byte and
    back with params_to_numpy; a leaf of the wrong geometry raises."""
    tree = jax.tree_util.tree_map(np.asarray, jq.quantize_for_serving(jparams, bits=bits))
    tparams = params_from_jax(tree, tiny_mistral(), device="cpu")
    back = _flat(params_to_numpy(tparams))
    for path, leaf in _flat(tree).items():
        assert back[path].dtype == leaf.dtype or leaf.dtype.name == "bfloat16", path
        np.testing.assert_array_equal(back[path], np.asarray(leaf, back[path].dtype))
    key = "q8" if bits == 8 else "q4"
    bad = {**tree, "layers": {**tree["layers"], "attn": {
        **tree["layers"]["attn"], "wq": {**tree["layers"]["attn"]["wq"],
                                         key: tree["layers"]["attn"]["wq"][key][:, :-2]}}}}
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(bad, tiny_mistral(), device="cpu")


# ------------------------------------------------- K6 / K7 plain versions


def _x_bf16(rng, *shape):
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16)
    return x, torch.from_numpy(_to_f32(x)).to(torch.bfloat16)


def _node_pair(quantize_jax, quantize_port, w, *args):
    jnode = quantize_jax(jnp.asarray(w), *args)
    tnode = quantize_port(torch.from_numpy(w), *args)
    return jnode, tnode


def _ulp(mag: np.ndarray) -> np.ndarray:
    """One bf16 ulp at magnitude `mag`: 2^(exponent - 7)."""
    return np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)


def _assert_kernel_close(got: torch.Tensor, want):
    got, want = _to_f32(got), _to_f32(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= KERNEL_RTOL, rel
    ulp = _ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= ulp).all(), float((np.abs(got - want) / ulp).max())


@pytest.mark.parametrize("M,K,N", [(8, 512, 256), (3, 512, 384), (16, 1024, 512),
                                   (300, 512, 256)])
def test_w8_plain_matches_jax_kernel(monkeypatch, M, K, N):
    """K6's plain version against the JAX w8a16 Pallas kernel (interpret
    mode) at the JAX tests' shapes."""
    monkeypatch.setattr(jqm, "_FORCE_KERNEL", True)
    rng = np.random.default_rng(4)
    w = rng.normal(size=(K, N)).astype(np.float32)
    jnode, tnode = _node_pair(jq.quantize_kernel, pq.quantize_kernel, w)
    jx, tx = _x_bf16(rng, M, K)
    got = qm.w8a16_matmul(tx, tnode)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    _assert_kernel_close(got, jqm.w8a16_matmul(jx, jnode))


@pytest.mark.parametrize("M,K,N,g", [(8, 512, 256, 32), (3, 512, 384, 32),
                                     (16, 2048, 512, 16)])
def test_w4_plain_matches_jax_kernel(monkeypatch, M, K, N, g):
    """K7's plain version against the JAX w4a16 Pallas kernel (interpret
    mode) at the JAX tests' shapes."""
    monkeypatch.setattr(jqm, "_FORCE_KERNEL", True)
    rng = np.random.default_rng(2)
    w = rng.normal(size=(K, N)).astype(np.float32)
    jnode, tnode = _node_pair(jq.quantize_kernel_int4, pq.quantize_kernel_int4, w, g)
    jx, tx = _x_bf16(rng, M, K)
    got = qm.w4a16_matmul(tx, tnode)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    _assert_kernel_close(got, jqm.w4a16_matmul(jx, jnode))


@pytest.mark.parametrize("bits", [8, 4])
def test_stacked_layer_view_matches_jax(monkeypatch, bits):
    """A layer of a [3, K, N] stack: the JAX kernel's prefetched layer index
    against the port's per-layer view (models/transformer._unstack), which
    shares the stack's storage."""
    from gritlm_tpu_torch.models.transformer import _unstack

    monkeypatch.setattr(jqm, "_FORCE_KERNEL", True)
    rng = np.random.default_rng(5)
    L, K, N = 3, 512, 256
    w = rng.normal(size=(L, K, N)).astype(np.float32)
    if bits == 8:
        jnode, tnode = _node_pair(jq.quantize_kernel, pq.quantize_kernel, w)
        jfn, tfn, key = jqm.w8a16_matmul, qm.w8a16_matmul, "q8"
    else:
        jnode, tnode = _node_pair(jq.quantize_kernel_int4, pq.quantize_kernel_int4, w, 32)
        jfn, tfn, key = jqm.w4a16_matmul, qm.w4a16_matmul, "q4"
    jx, tx = _x_bf16(rng, 4, K)
    views = _unstack({"w": tnode}, L)
    for lidx in range(L):
        view = views[lidx]["w"]
        assert view[key].untyped_storage().data_ptr() == tnode[key].untyped_storage().data_ptr()
        _assert_kernel_close(tfn(tx, view), jfn(jx, {**jnode, "lidx": jnp.int32(lidx)}))


@pytest.mark.parametrize("bits", [8, 4])
def test_routing_by_rows(monkeypatch, bits):
    """Up to the kernel's row ceiling a CPU tensor takes the plain version;
    above it the layer is dequantized once and multiplied, the function the
    JAX package runs at those rows (`_reference8` / `_reference`)."""
    rng = np.random.default_rng(6)
    K, N = 256, 128
    w = rng.normal(size=(K, N)).astype(np.float32)
    if bits == 8:
        jnode, tnode = _node_pair(jq.quantize_kernel, pq.quantize_kernel, w)
        fn, plain_name, ceiling, ref = (qm.w8a16_matmul, "w8a16_matmul_plain",
                                        qm.MAX_KERNEL_ROWS8, jqm._reference8)
    else:
        jnode, tnode = _node_pair(jq.quantize_kernel_int4, pq.quantize_kernel_int4, w)
        fn, plain_name, ceiling, ref = (qm.w4a16_matmul, "w4a16_matmul_plain",
                                        qm.MAX_KERNEL_ROWS, jqm._reference)
    assert ceiling == (jqm.MAX_KERNEL_ROWS8 if bits == 8 else jqm.MAX_KERNEL_ROWS)
    plain = getattr(qm, plain_name)
    calls = []
    monkeypatch.setattr(qm, plain_name, lambda *a: calls.append(1) or plain(*a))
    jx, tx = _x_bf16(rng, 2, ceiling // 2, K)  # [2, ceiling/2, K]: at the ceiling
    assert tuple(fn(tx, tnode).shape) == (2, ceiling // 2, N) and calls == [1]
    jx, tx = _x_bf16(rng, ceiling + 1, K)
    got = fn(tx, tnode)
    assert calls == [1]  # above the ceiling: no plain (kernel) path
    # the same bf16 product, summed in another order by torch and XLA
    _assert_kernel_close(got, ref(jx, jnode))


@pytest.mark.parametrize("M,K,N", [(1, 4096, 1024), (8, 4096, 14336), (8, 14336, 4096),
                                   (2, 4096, 32000), (256, 4096, 4096), (512, 4096, 14336),
                                   (3, 2048, 1024), (128, 7168, 4096)])
def test_plan_covers_the_contracting_axis(M, K, N):
    """The staged template's split plan: one block height (BM rows; decode
    rows go to the rows kernel, `plan_w8`), every stage in exactly one
    split, no empty split, at most MAX_SPLITS, and no plan with fewer waves
    x stages a block."""
    stages = -(-K // qm.DK)
    bm, splits, kper = qm.plan(M, stages, N, 132)
    assert bm == qm.BM
    assert 1 <= splits <= qm.MAX_SPLITS and (splits - 1) * kper < stages <= splits * kper
    tiles = -(-N // qm.BN) * -(-M // bm)

    def cost(s):
        k = -(-stages // s)
        return -(-tiles * -(-stages // k) // 264) * (k + 1)

    assert cost(splits) == min(cost(s) for s in range(1, min(stages, qm.MAX_SPLITS) + 1))
    assert tiles * splits >= min(132, tiles * stages)  # at least one block an SM when it can


# ------------------------------------------------------------ the model


@pytest.fixture(scope="module")
def jax_model(jparams):
    return JaxGritLM(jax_tiny_mistral(), params=jparams, mode="unified", attn="bbcc")


def _port_model(np_params, **kw):
    return GritLM(tiny_mistral(), params=params_from_jax(np_params, tiny_mistral(), device="cpu"),
                  device="cpu", **kw)


SENTS = ["A cat sat on the mat.", "Bitcoin is a peer-to-peer currency.", "zeta"]
PROMPTS = ["<|user|>\nSay a word\n<|assistant|>\n", "<|user|>\nHi\n<|assistant|>\n"]


@pytest.mark.parametrize("bits", [8, 4])
def test_weight_quant_encode_matches_jax(jparams, np_params, bits):
    """GritLM(weight_quant=8|4).encode: cosine >= 0.9999 to the JAX
    package's quantized encode; the layer kernels and the LM head are
    quantized, the embedding stays dense."""
    jm = JaxGritLM(jax_tiny_mistral(), params=jparams, weight_quant=bits)
    pm = _port_model(np_params, weight_quant=bits)
    key, dt = ("q8", torch.int8) if bits == 8 else ("q4", torch.uint8)
    for name in ("wq", "wk", "wv", "wo"):
        assert pm.params["layers"]["attn"][name][key].dtype == dt
    assert pm.params["lm_head"]["kernel"][key].dtype == dt
    assert pm.params["embed"]["embedding"].dtype == torch.float32
    instr = "<|user|>\nRepresent\n<|embed|>\n"
    a, b = jm.encode(SENTS, instruction=instr), pm.encode(SENTS, instruction=instr)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert float(cos.min()) >= COS_MIN, cos


@pytest.mark.parametrize("bits,kv_quant", [(8, False), (4, False), (8, True), (4, True)])
def test_weight_quant_generate_matches_jax(jparams, np_params, bits, kv_quant):
    """Greedy tokens of GritLM(weight_quant=8|4), with and without the
    int8 KV cache, equal to the JAX package's."""
    jm = JaxGritLM(jax_tiny_mistral(), params=jparams, weight_quant=bits, kv_quant=kv_quant)
    pm = _port_model(np_params, weight_quant=bits, kv_quant=kv_quant)
    enc = jm.tokenizer(PROMPTS)
    want = np.asarray(jm.generate_from_ids(enc["input_ids"], enc["attention_mask"],
                                           max_new_tokens=10).tokens)
    got = pm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=10)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    assert got.cache.quantized == kv_quant


def test_serving_engine_w4_matches_jax(jparams, np_params):
    """ServingEngine over int4 params (more requests than slots): the JAX
    engine's greedy tokens."""
    pool = dict(max_batch=3, max_len=32, chunk_size=4, prompt_buckets=(16,))
    rng = np.random.default_rng(0)
    specs = [(f"r{i}", rng.integers(3, 512, size=n).tolist()) for i, n in
             enumerate([3, 9, 5, 12, 7])]
    jeng = JaxServingEngine(jax_tiny_mistral(), jq.quantize_for_serving(jparams, bits=4), **pool)
    want = {c.request_id: list(c.token_ids) for c in jeng.run(
        [JaxRequest(input_ids=ids, max_new_tokens=8, request_id=rid) for rid, ids in specs])}
    tparams = pq.quantize_for_serving(params_from_jax(np_params, tiny_mistral(), device="cpu"),
                                      bits=4)
    eng = ServingEngine(tiny_mistral(), tparams, device="cpu", **pool)
    got = {c.request_id: list(c.token_ids) for c in eng.run(
        [Request(input_ids=ids, max_new_tokens=8, request_id=rid) for rid, ids in specs])}
    assert got == want


# ------------------------------------------- checkpoints and the CLIs


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, np_params):
    """tiny_mistral's JAX weights written by the port's save_checkpoint, with
    a BPE tokenizer.json beside them."""
    path = tmp_path_factory.mktemp("ckpt")
    save_checkpoint(str(path), tiny_mistral(),
                    params_from_jax(np_params, tiny_mistral(), device="cpu"))
    make_bpe_tokenizer()._tok.save(str(path / "tokenizer.json"))
    return path


def test_from_pretrained_matches_jax(checkpoint):
    """GritLM.from_pretrained reads the weights and the tokenizer: the JAX
    from_pretrained's token ids, embeddings (cosine >= 0.9999) and greedy
    tokens, also with int4 weights."""
    for kw in (dict(), dict(weight_quant=4)):
        jm = JaxGritLM.from_pretrained(str(checkpoint), **kw)
        pm = GritLM.from_pretrained(str(checkpoint), device="cpu", **kw)
        assert type(pm.tokenizer).__name__ == "HFTokenizer"
        enc = jm.tokenizer(PROMPTS)
        np.testing.assert_array_equal(pm.tokenizer(PROMPTS)["input_ids"], enc["input_ids"])
        a, b = jm.encode(SENTS), pm.encode(SENTS)
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        assert float(cos.min()) >= COS_MIN, (kw, cos)
        want = jm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
        got = pm.generate_from_ids(enc["input_ids"], enc["attention_mask"], max_new_tokens=8)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def _lines(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


@pytest.mark.parametrize("flags", [[], ["--weight_quant", "4"], ["--weight_quant"]],
                         ids=["dense", "weight_quant 4", "weight_quant"])
def test_serve_cli_from_checkpoint_matches_jax(tmp_path, checkpoint, flags):
    """`serve --model_name_or_path ckpt [--weight_quant [4]] --device cpu`:
    the JAX CLI's summary and line schema, and, on the same weights, its
    greedy tokens."""
    reqs = tmp_path / "reqs.jsonl"
    rows = [{"id": "g0", "prompt": "<s><|user|>\nHi\n<|assistant|>\n", "max_new_tokens": 5},
            {"id": "g1", "prompt": "<s><|user|>\nName a city\n<|assistant|>\n"},
            {"id": "e0", "type": "embed", "text": "a passage to embed"}]
    reqs.write_text("".join(json.dumps(r) + "\n" for r in rows))
    common = ["--model_name_or_path", str(checkpoint), "--requests", str(reqs), "--slots", "2",
              "--max_len", "128", "--prompt_buckets", "64", "--max_new_tokens", "4", *flags]
    want_summary = jax_serve.main(common + ["--out", str(tmp_path / "jax.jsonl")])
    got_summary = port_serve.main(common + ["--device", "cpu", "--out",
                                            str(tmp_path / "port.jsonl")])
    assert sorted(got_summary) == sorted(want_summary)
    for key in ("requests", "completions", "embeddings"):
        assert got_summary[key] == want_summary[key]
    want = {r["id"]: r for r in _lines(tmp_path / "jax.jsonl")}
    got = {r["id"]: r for r in _lines(tmp_path / "port.jsonl")}
    assert {k: sorted(v) for k, v in got.items()} == {k: sorted(v) for k, v in want.items()}
    for rid in ("g0", "g1"):
        assert got[rid]["token_ids"] == want[rid]["token_ids"], rid


def _files_and_keys(d):
    out = {}
    for path in sorted(d.iterdir()):
        data = json.loads(path.read_text())
        out[path.name] = {k: sorted(v) if isinstance(v, dict) else None for k, v in data.items()}
    return out


@pytest.mark.parametrize("flags", [[], ["--weight_quant"]], ids=["dense", "weight_quant"])
def test_rag_eval_cli_from_checkpoint_matches_jax(tmp_path, checkpoint, flags):
    """`rag.eval --model_name_or_path ckpt [--weight_quant] --device cpu`
    writes the JAX CLI's file names and JSON keys."""
    passages, qa = tmp_path / "passages.jsonl", tmp_path / "qa.jsonl"
    passages.write_text("".join(json.dumps({"title": "geo", "text": f"fact {i} about {i}"})
                                + "\n" for i in range(6)))
    qa.write_text("".join(json.dumps({"question": q, "answers": ["4"]}) + "\n"
                          for q in ("what is fact 3?", "tell me about 5")))
    common = ["--model_name_or_path", str(checkpoint), "--max_new_tokens", "2", "--embedbs", "4",
              "--passages", str(passages), "--eval_data", str(qa), "--cache", "doc",
              "--max_length", "64", *flags]
    jax_eval.main(common + ["--save_dir", str(tmp_path / "jax")])
    port_eval.main(common + ["--device", "cpu", "--save_dir", str(tmp_path / "port")])
    want, got = _files_and_keys(tmp_path / "jax"), _files_and_keys(tmp_path / "port")
    assert got == want and len(got) == 1


# ---------------------------------------------------------------- QLoRA


def _batch():
    coll = GritCollator(ByteTokenizer(), query_max_len=32, passage_max_len=32,
                        generative_max_len=48)
    return coll([(("find it", f"query number {i}"),
                  [("find it", f"matching passage {i}"), ("find it", f"junk {i}")],
                  [f"what is {i}?", f"it is {i}"]) for i in range(4)])


@pytest.fixture(scope="module")
def qlora_runs(jparams, np_params):
    """Three QLoRA steps in both packages from the same int8 base and the
    same bf16 adapters: the JAX package's make_lora_train_state(quantize=
    True) on a one-device mesh, and the port's."""
    opt = dict(total_steps=10, warmup_ratio=0.1, learning_rate=2e-3, temperature=0.05,
               remat=False)
    batch = _batch()
    jrun, jstate, jbase, jscale = jax_make_lora_train_state(
        single_device_mesh(), jax_tiny_mistral(), jt.TrainConfig(mode="unified", **opt),
        jparams, r=4, alpha=8, quantize=True, seed=3)
    tc = pt.TrainConfig(mode="unified", **opt)
    run, state, base, scale = make_lora_train_state(
        tiny_mistral(), tc, params_from_jax(np_params, tiny_mistral(), device="cpu"),
        r=4, alpha=8, quantize=True, device="cpu")
    start = lora_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), device="cpu")
    with torch.no_grad():  # the JAX package's adapters in the port's state
        for name, node in state.params["layers"].items():
            for w, ab in node.items():
                for x in ("A", "B"):
                    assert ab[x].dtype == torch.bfloat16
                    ab[x].copy_(start["layers"][name][w][x])
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    metrics = []
    for _ in range(3):
        jstate, jm = jrun(jstate, jbatch)
        state, m = run(state, batch)
        metrics.append((m, jm))
    return dict(metrics=metrics, state=state, base=base, scale=scale, jstate=jstate,
                jbase=jbase, jscale=jscale)


def test_qlora_train_step_matches_jax(qlora_runs):
    """The int8 base (bytes equal to the JAX package's), bf16 adapters, and
    three steps. Steps 1 and 2 (LR 0 on the first update, so both losses
    come from the starting adapters) within 1e-5 relative. Step 3 follows
    the first bf16 Adam update, whose moments and adapters round to bf16 in
    another order in each package (a fifth of the adapters land one bf16
    ulp apart), hence 1e-3. The grad norm is summed in fp32 in the port;
    optax rounds the bf16 adapters' sums of squares to bf16, hence 1e-2."""
    base, jbase = qlora_runs["base"], qlora_runs["jbase"]
    for path, leaf in _flat(jax.tree_util.tree_map(np.asarray, jbase)).items():
        np.testing.assert_array_equal(_to_f32(_flat(base)[path]), _to_f32(leaf),
                                      err_msg=str(path))
    assert _flat(base)[("layers", "attn", "wq", "q8")].dtype == torch.int8
    for step, (m, jm) in enumerate(qlora_runs["metrics"], 1):
        for name in ("loss", "loss_emb", "loss_gen"):
            np.testing.assert_allclose(float(getattr(m, name)), float(getattr(jm, name)),
                                       rtol=LOSS_RTOL if step < 3 else 1e-3, atol=1e-6,
                                       err_msg=f"step {step} {name}")
        np.testing.assert_allclose(float(m.grad_norm), float(jm.grad_norm), rtol=1e-2)
    assert float(qlora_runs["state"].params["layers"]["mlp"]["up"]["B"].detach().abs().max()) > 0


def test_qlora_f32_adapters_match_jax(jparams, np_params):
    """The QLoRA path itself (the int8 base dequantized per layer under the
    lazy adapters) with float32 adapters, where no bf16 rounding of the
    update intervenes: three steps of the port's train_step against the JAX
    package's QLoRA loss under its optax chain, losses within 1e-5."""
    opt = dict(total_steps=10, warmup_ratio=0.1, learning_rate=2e-3, temperature=0.05,
               remat=False)
    jtc = jt.TrainConfig(mode="unified", **opt)
    jbase = jq.quantize_tree(jparams)
    jlora, scale = jax_init_lora(jbase, jax.random.PRNGKey(3), r=4, alpha=8)
    jlora = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jlora)
    loss_fn = jax_lora_fns(jbase, jax_tiny_mistral(), jtc, scale)
    jopt = jt.make_optimizer(jtc)
    batch = _batch()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    @jax.jit
    def jstep(lora, opt_state):
        (loss, (le, lg)), g = jax.value_and_grad(loss_fn, has_aux=True)(lora, jbatch)
        upd, opt_state = jopt.update(g, opt_state, lora)
        return optax.apply_updates(lora, upd), opt_state, (loss, le, lg)

    tc = pt.TrainConfig(mode="unified", **opt)
    base = pq.quantize_tree(params_from_jax(np_params, tiny_mistral(), device="cpu"))
    state = pt.init_train_state(lora_from_jax(jax.tree_util.tree_map(np.asarray, jlora),
                                              device="cpu"), tc)
    cur, opt_state = jlora, jopt.init(jlora)
    for step in (1, 2, 3):
        cur, opt_state, want = jstep(cur, opt_state)
        state, m = pt.train_step(state, batch, tiny_mistral(), tc,
                                 params_fn=lambda tree: apply_lora_lazy(base, tree, scale))
        for name, w in zip(("loss", "loss_emb", "loss_gen"), want):
            np.testing.assert_allclose(float(getattr(m, name)), float(w), rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=f"step {step} {name}")


def test_qlora_merge_is_dense(qlora_runs):
    """merge over the int8 base gives dense bf16 kernels (the export): the
    JAX package's merge of the same adapters within one bf16 ulp (the fp32
    delta A @ B summed in another order)."""
    adapters = lora_from_jax(jax.tree_util.tree_map(np.asarray, qlora_runs["jstate"].params),
                             device="cpu")
    got = _flat(merge(qlora_runs["base"], adapters, qlora_runs["scale"]))
    want = _flat(jax_merge(qlora_runs["jbase"], qlora_runs["jstate"].params,
                           qlora_runs["jscale"]))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert isinstance(got[path], torch.Tensor), path
        if path[-1] in pq.DEFAULT_TARGETS:
            assert got[path].dtype == torch.bfloat16, path
        a, b = _to_f32(got[path]), _to_f32(leaf)
        assert (np.abs(a - b) <= _ulp(np.maximum(np.abs(a), np.abs(b)))).all(), path
