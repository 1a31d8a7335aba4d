"""LoRA merging (``models/lora.py``) against the JAX package's
``apply_lora``: kohya keys written from the JAX converter's own records,
merged by both packages into tiny fp32 SDXL and SD 1.5 bundles (and a
1×1-conv ``proj_in`` UNet); the patched UNet and conditioner within
2e-4 of JAX's, the same tensor counts merged, the base bundle unchanged
and sharing every unpatched parameter; and the ``LoraLoader`` node."""

import functools

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
st_numpy = pytest.importorskip("safetensors.numpy")

from comfyui_distributed_tpu.models import lora as jlora  # noqa: E402
from comfyui_distributed_tpu_torch.graph.node import get_node  # noqa: E402
from comfyui_distributed_tpu_torch.models import lora as tlora  # noqa: E402
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry  # noqa: E402
from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError  # noqa: E402
from torch_ckpt_fixtures import jax_bundle, port_from_jax, presets  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4


def _lora_sd(jb, seed=0, rank=4, alpha=2.0, every=1):
    """A kohya LoRA over the attention, ff and proj sites of ``jb``'s UNet
    and every CLIP Linear of its text towers, keys from the JAX records;
    ``every`` > 1 keeps one site in ``every``."""
    rng = np.random.default_rng(seed)
    cfg = jb.preset.unet
    lp = not (cfg.context_dim == 768 and cfg.adm_in_channels == 0)
    sites = [("lora_unet_", "model.diffusion_model.", r)
             for r in jlora.unet_records(cfg, linear_proj=lp)]
    stack = jb.clip_stack
    towers = ([("lora_te1_", stack.clip_l), ("lora_te2_", stack.clip_g)]
              if jb.preset.clip == "sdxl" else
              [("lora_te_", stack)] if stack is not None else [])
    for prefix, enc in towers:
        sites += [(prefix + "text_model_", "text_model.", r)
                  for r in jlora.clip_hf_records(enc.config)]
    out = {}
    kept = 0
    for lprefix, cprefix, (src, dst, tx) in sites:
        if not src.endswith(".weight") or not any(
                s in src for s in (".to_", "ff.net", "proj_in", "proj_out",
                                   "_proj.", "mlp.fc")):
            continue
        kept += 1
        if kept % every:
            continue
        shape = _source_shape(jb, lprefix, dst, tx)
        n_out, n_in = shape[0], int(np.prod(shape[1:]))
        key = lprefix + src[len(cprefix):-len(".weight")].replace(".", "_")
        if len(shape) == 4:
            out[f"{key}.lora_down.weight"] = rng.standard_normal(
                (rank, *shape[1:])).astype(np.float32) / n_in ** 0.5
            out[f"{key}.lora_up.weight"] = rng.standard_normal(
                (n_out, rank, 1, 1)).astype(np.float32) * 0.1
        else:
            out[f"{key}.lora_down.weight"] = rng.standard_normal(
                (rank, n_in)).astype(np.float32) / n_in ** 0.5
            out[f"{key}.lora_up.weight"] = rng.standard_normal(
                (n_out, rank)).astype(np.float32) * 0.1
        out[f"{key}.alpha"] = np.array(alpha, np.float32)
    return out


def _source_shape(jb, lprefix, dst, tx):
    """The torch-layout shape of the site a JAX record maps to."""
    from comfyui_distributed_tpu.models import convert as jconvert

    if lprefix == "lora_unet_":
        tree = jb.pipeline.unet_params["params"]
    elif lprefix.startswith("lora_te2_"):
        tree = jb.clip_stack.clip_g.params["params"]
    elif jb.preset.clip == "sdxl":
        tree = jb.clip_stack.clip_l.params["params"]
    else:
        tree = jb.clip_stack.params["params"]
    shape = jconvert._get_path(tree, dst).shape
    if tx is jconvert._lin:
        return tuple(reversed(shape))
    if tx is jconvert._conv1x1_to_dense:
        return (shape[1], shape[0], 1, 1)
    return tuple(shape)


@functools.cache
def _pair(clip, context_dim=0, seed=1):
    """One JAX bundle and its port twin per preset, shared by the tests
    (each checks that a merge leaves the base bundle untouched)."""
    jp, tp = presets(clip, context_dim)
    jb = jax_bundle(jp, seed=seed)
    return jb, port_from_jax(tp, jb)


def _unet_inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([20.0, 600.0], np.float32)
    ctx = rng.standard_normal((2, 16, cfg.context_dim)).astype(np.float32)
    y = (rng.standard_normal((2, cfg.adm_in_channels)).astype(np.float32)
         if cfg.adm_in_channels else None)
    return x, t, ctx, y


def _compare_unets(jpatched, tpatched):
    cfg = jpatched.preset.unet
    x, t, ctx, y = _unet_inputs(cfg)
    ref = jpatched.pipeline.unet.apply(jpatched.pipeline.unet_params, x, t, ctx, y)
    with torch.no_grad():
        out = tpatched.core(*(None if a is None else torch.from_numpy(a)
                              for a in (x, t, ctx, y)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    return out


@pytest.mark.parametrize("clip,strengths", [
    ("sdxl", (1.0, 1.0)), ("sdxl", (0.5, 0.0)), ("clip-l", (0.7, 1.3))])
def test_merge_matches_jax(clip, strengths):
    jb, tb = _pair(clip)
    lora = _lora_sd(jb, seed=3)
    lora["lora_unet_not_a_module.lora_down.weight"] = np.zeros((4, 2), np.float32)
    sm, sc = strengths
    jpatched, jcond = jlora.apply_lora(jb, lora, strength_model=sm,
                                       strength_clip=sc)
    tl = {k: torch.from_numpy(v) for k, v in lora.items()}
    before = {k: p.clone() for k, p in tb.core.named_parameters()}
    texts = ["a cat on a mat", ""]
    base_ctx, _ = tb.text_encoder.encode(texts)
    tpatched, tcond = tlora.apply_lora(tb, tl, strength_model=sm,
                                       strength_clip=sc)
    # the counts JAX merges
    cfg = jb.preset.unet
    n_unet = len(jlora.collect_deltas(lora, jlora.unet_records(cfg), "lora_unet_",
                                      "model.diffusion_model.", sm)[0])
    assert tpatched.lora_merged[0] == n_unet > 0
    assert tpatched.lora_merged[2] == (1 if sc else 1 + sum(
        1 for k in lora if k.startswith("lora_te")))
    out = _compare_unets(jpatched, tpatched)
    with torch.no_grad():
        base = tb.core(*(None if a is None else torch.from_numpy(a)
                         for a in _unet_inputs(cfg)))
    assert not torch.allclose(out, base)
    assert (tcond is None) == (jcond is None) == (not sc)
    if sc:
        jctx, jpooled = jcond.encode(texts)
        tctx, tpooled = tcond.encode(texts)
        np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(tpooled.numpy(), np.asarray(jpooled),
                                   atol=TOL, rtol=TOL)
        assert tpatched.text_encoder is tcond
        assert tpatched.lora_merged[1] > 0
        assert not hasattr(tcond, "_cdt_encoder_id")
    # the base bundle is untouched, and shares what was not patched
    for k, p in tb.core.named_parameters():
        assert torch.equal(p, before[k])
    torch.testing.assert_close(tb.text_encoder.encode(texts)[0], base_ctx)
    patched = dict(tpatched.core.named_parameters())
    shared = [k for k, p in tb.core.named_parameters() if patched[k] is p]
    assert "conv_in.weight" in shared and len(shared) < len(patched)
    assert tpatched.pipeline is not tb.pipeline
    assert tb.pipeline.unet is tb.core


def test_conv_lora_on_conv_proj_unet():
    """SD 1.5-style 1×1-conv ``proj_in``/``proj_out``: conv-shaped LoRA
    pairs squeezed onto the port's Linears, as JAX does."""
    jb, tb = _pair(None, context_dim=768)
    lora = _lora_sd(jb, seed=4)
    assert any(v.ndim == 4 for k, v in lora.items() if "proj_in" in k)
    jpatched, _ = jlora.apply_lora(jb, lora)
    tpatched, cond = tlora.apply_lora(
        tb, {k: torch.from_numpy(v) for k, v in lora.items()})
    assert cond is None
    _compare_unets(jpatched, tpatched)


def test_shape_mismatch_and_kind_are_refused():
    jb, tb = _pair("sdxl")
    lora = _lora_sd(jb, seed=5)
    key = next(k for k in lora if k.endswith("lora_up.weight")
               and k.startswith("lora_unet_"))
    lora[key] = np.zeros((3, lora[key].shape[1]), np.float32)
    with pytest.raises(ValidationError, match="shape"):
        tlora.apply_lora(tb, {k: torch.from_numpy(v) for k, v in lora.items()})
    flux = ModelRegistry("cpu").get("flux-tiny")
    with pytest.raises(ValidationError, match="unet-kind"):
        tlora.apply_lora(flux, {})


def test_lora_loader_node(tmp_path, monkeypatch):
    jb, tb = _pair("sdxl")
    lora = _lora_sd(jb, seed=6, every=3)
    (tmp_path / "loras").mkdir()
    st_numpy.save_file(lora, str(tmp_path / "loras" / "style.safetensors"))
    node = get_node("LoraLoader")()
    node._cache.clear()
    monkeypatch.delenv("CDT_LORA_DIR", raising=False)
    registry = ModelRegistry("cpu", checkpoint_root=tmp_path)
    clip = tb.text_encoder
    # <checkpoint root>/loras is the fallback directory
    m1, c1 = node.execute(tb, clip, "style", 0.8, 0.6, model_registry=registry)
    assert m1 is not tb and c1 is not clip and m1.lora_merged[2] == 0
    m2, c2 = node.execute(tb, clip, "style.safetensors", 0.8, 0.6,
                          model_registry=registry)
    assert (m2, c2) != (m1, c1)            # another name, another entry
    assert node.execute(tb, clip, "style", 0.8, 0.6,
                        model_registry=registry) == (m1, c1)
    assert node.execute(tb, clip, "style", 0.0, 0.0) == (tb, clip)
    jpatched, jcond = jlora.apply_lora(jb, lora, strength_model=0.8,
                                       strength_clip=0.6)
    _compare_unets(jpatched, m1)
    # CDT_LORA_DIR wins over the checkpoint root; a missing name raises
    monkeypatch.setenv("CDT_LORA_DIR", str(tmp_path / "elsewhere"))
    with pytest.raises(ValidationError, match="not found"):
        node.execute(tb, clip, "style", 1.0, 1.0, model_registry=registry)
    monkeypatch.delenv("CDT_LORA_DIR")
    for strength in (0.1, 0.2, 0.3, 0.4, 0.5):
        node.execute(tb, clip, "style", strength, 0.0, model_registry=registry)
    assert len(node._cache) == node.KEPT
    node._cache.clear()


def test_clear_memory_releases_the_lora_base_bundle(tmp_path, monkeypatch):
    """``LoraLoader`` keeps its last merges in a class-level cache, each
    pinning its base bundle: ``Controller.clear_memory`` drops them with
    the registry, so the base bundle is collectable afterwards."""
    import gc
    import weakref

    from comfyui_distributed_tpu_torch.cluster.controller import Controller
    from comfyui_distributed_tpu_torch.models.convert import linear_proj_of
    from comfyui_distributed_tpu_torch.utils.safetensors import save_file

    monkeypatch.delenv("CDT_IS_WORKER", raising=False)
    controller = Controller(tmp_path / "config.json", device="cpu")
    bundle = controller.model_registry.get("tiny")
    cfg = bundle.preset.unet
    gen = torch.Generator().manual_seed(0)
    lora = {}
    for src, dst, _ in tlora.unet_records(cfg, linear_proj_of(cfg)):
        if ".to_q." in src:
            n_out, n_in = bundle.core.get_parameter(dst).shape
            key = "lora_unet_" + src[len("model.diffusion_model."):
                                     -len(".weight")].replace(".", "_")
            lora[f"{key}.lora_down.weight"] = torch.randn(2, n_in, generator=gen)
            lora[f"{key}.lora_up.weight"] = torch.randn(n_out, 2, generator=gen)
    save_file(lora, tmp_path / "tiny-lora.safetensors")
    monkeypatch.setenv("CDT_LORA_DIR", str(tmp_path))
    node = get_node("LoraLoader")()
    patched, _ = node.execute(bundle, bundle.text_encoder, "tiny-lora",
                              model_registry=controller.model_registry)
    assert patched.lora_merged[0] == len(lora) // 2 > 0
    assert len(node._cache) == 1
    base = weakref.ref(bundle)
    del bundle, patched
    controller.clear_memory()
    gc.collect()
    assert not node._cache and base() is None
