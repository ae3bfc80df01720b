"""The head's variants, the port against the JAX package at toy width in
fp32: the ISA fuse layer (including an input that 8 does not divide), the
'conv' and 'sep_conv' fuse layers, ``final_fuse_vae_decoder_feat`` and the
concat slot, each in eval BN (running statistics) and train BN (batch
statistics, with the running statistics' update); ``SegFormerHead``; the
eval-head dispatch for heads the kernels do not serve; the second head's
kernel eval heads on its own weights; and the variants' checkpoint keys.
Logits within 1e-4 x max(1, max|logit|), BN statistics within 1e-5 x
max(1, max|stat|)."""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from madm_tpu.checkpoint.converter import convert_daformer_head
from madm_tpu.models.daformer import DAFormerHead as JaxHead
from madm_tpu.models.segformer import SegFormerHead as JaxSegFormer
from madm_torch.checkpoint import convert_madm_pth, merge_into_model, reference_state_dict
from madm_torch.models.daformer import DAFormerHead
from madm_torch.models.madm import MADM, MADMConfig, init_random_
from madm_torch.models.segformer import SegFormerHead
from torch_port_toy import TOY, assert_close, sure_pixels, toy_pair

KEYS = ("s0", "s3", "s4", "s5")
CIN = (16, 32, 32, 32)
# (fusion, final_fuse, concat, s0 side): 36 is not a multiple of ISA's 8
CASES = {"isa": ("isa", False, False, 32), "isa_ragged": ("isa", False, False, 36),
         "conv": ("conv", False, False, 32), "sep_conv": ("sep_conv", False, False, 32),
         "final_fuse": ("aspp", True, False, 32), "concat": ("aspp", False, True, 32),
         "isa_final_fuse": ("isa", True, False, 36)}


def _init(module: nn.Module, seed: int) -> nn.Module:
    """Seeded weights, BN affine and running statistics away from identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(1 + torch.rand(m.running_var.shape, generator=g))
    return module


def _features(side, seed=0, b=2):
    rng = np.random.default_rng(seed)
    sizes = (side, 8, 4, 2)
    return {k: rng.standard_normal((b, s, s, c)).astype(np.float32) for k, s, c in zip(KEYS, sizes, CIN)}


def _nchw(feats):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()}


def _leaves(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, path + (k,)) if isinstance(v, dict) else {path + (k,): np.asarray(v)})
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval_bn", "train_bn"])
@pytest.mark.parametrize("case", list(CASES))
def test_head_variant_matches_jax(case, train):
    fusion, final_fuse, concat, side = CASES[case]
    head = _init(DAFormerHead(CIN, KEYS, 11, channels=64, embed_dims=32, fusion=fusion,
                              final_fuse_vae_decoder_feat=final_fuse, concat_attention_to_conv_seg=concat),
                 seed=len(case))
    jhead = JaxHead(KEYS, 11, channels=64, embed_dims=32, fusion=fusion,
                    final_fuse_vae_decoder_feat=final_fuse, concat_attention_to_conv_seg=concat,
                    dropout_ratio=0.0)
    sd = {f"h.{k}": v.numpy() for k, v in head.state_dict().items()}
    params, stats = convert_daformer_head(sd, "h")
    feats = _features(side)
    att = None
    if concat:  # the slot reads a map at another resolution, resized to the fused features
        att = np.random.default_rng(5).uniform(size=(2, 8, 8, 11)).astype(np.float32)
    out_j = jhead.apply({"params": params, "batch_stats": stats}, feats, train=train,
                        cross_attention_feat=att, mutable=["batch_stats"] if train else False)
    logits_j, new_stats = out_j if train else (out_j, None)
    att_t = None if att is None else torch.from_numpy(att).permute(0, 3, 1, 2)
    logits = head(_nchw(feats), train=train, update_bn=train, cross_attention_feat=att_t)
    assert_close(logits.detach().permute(0, 2, 3, 1), logits_j, 1e-4)
    assert logits.shape[2:] == (side, side)
    if train:  # the running statistics after the update, under JAX's names
        updated = {f"h.{k}": v.numpy() for k, v in head.state_dict().items()}
        ours, ref = _leaves(convert_daformer_head(updated, "h")[1]), _leaves(new_stats["batch_stats"])
        assert set(ours) == set(ref) and ref
        for k, v in ref.items():
            assert_close(ours[k], v, 1e-5)


@pytest.mark.parametrize("train", [False, True], ids=["eval_bn", "train_bn"])
def test_segformer_head_matches_jax(train):
    head = _init(SegFormerHead(CIN, KEYS, 11, embed_dims=32), seed=3)
    sd = {k: v.numpy() for k, v in head.state_dict().items()}
    params = {f"linear_c{i}": {"kernel": sd[f"linear_c{i}.weight"].T, "bias": sd[f"linear_c{i}.bias"]}
              for i in range(4)}
    params["linear_fuse"] = {"conv": {"kernel": sd["linear_fuse.conv.weight"].transpose(2, 3, 1, 0)},
                             "bn": {"scale": sd["linear_fuse.bn.weight"], "bias": sd["linear_fuse.bn.bias"]}}
    params["conv_seg"] = {"kernel": sd["conv_seg.weight"].transpose(2, 3, 1, 0), "bias": sd["conv_seg.bias"]}
    stats = {"linear_fuse": {"bn": {"mean": sd["linear_fuse.bn.running_mean"],
                                    "var": sd["linear_fuse.bn.running_var"]}}}
    feats = _features(24, seed=2)
    jhead = JaxSegFormer(KEYS, 11, embed_dims=32, dropout_ratio=0.0)
    out = jhead.apply({"params": params, "batch_stats": stats}, feats, train=train,
                      mutable=["batch_stats"] if train else False)
    ref = out[0] if train else out
    logits = head(_nchw(feats), train=train, update_bn=train)
    assert_close(logits.detach().permute(0, 2, 3, 1), ref, 1e-4)
    if train:
        new = out[1]["batch_stats"]["linear_fuse"]["bn"]
        assert_close(head.linear_fuse.bn.running_mean, new["mean"], 1e-5)
        assert_close(head.linear_fuse.bn.running_var, new["var"], 1e-5)


VARIANT_HEADS = {"isa": dict(head_fusion="isa"), "sep_conv": dict(head_fusion="sep_conv"),
                 "final_fuse": dict(final_fuse_vae_decoder_feat=True),
                 "concat": dict(concat_attention_to_conv_seg=True, attention_features_res=(16, 32),
                                attention_features_location=("up",),
                                attention_select_index=tuple(range(1, 12)))}


@pytest.mark.parametrize("name", list(VARIANT_HEADS))
def test_eval_head_dispatch_refuses_the_kernel_heads(name):
    """'auto' gives 'none' for a head the kernels do not serve, and a kernel
    head asked for by name raises (JAX ``_eval_head_mode`` / ``head_ids``);
    the 'none' pass runs."""
    model = init_random_(MADM(MADMConfig(**TOY, compute_dtype=torch.float32, **VARIANT_HEADS[name]),
                              device="cpu"), torch.Generator().manual_seed(0))
    assert model.eval_head_mode() == "none"
    for mode in ("aspp", "full", "argmax"):
        with pytest.raises(ValueError, match="does not fit"):
            model.eval_head_mode(mode)
    ids = model.eval_forward_ids(torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(1)))
    assert ids.shape == (1, 64, 64)


@pytest.fixture(scope="module")
def sec_pair():
    """A toy model with the second head, its weights moved off the first's,
    and JAX's eval logits (which read ``head_sec``)."""
    port, jm, _ = toy_pair(sem_seg_head_sec_modal=True)
    with torch.no_grad():
        g = torch.Generator().manual_seed(9)
        for p in port.sem_seg_head_sec_modal.parameters():
            p.mul_(1 + 0.3 * torch.randn(p.shape, generator=g))
        port.sem_seg_head_sec_modal.conv_seg.weight.mul_(30.0)
    from torch_port_toy import jax_variables

    jvars = jax_variables(port)
    images = np.random.default_rng(4).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.eval_forward)(jvars, images))
    return port, images, ref


def test_second_head_eval_logits_match_jax(sec_pair):
    port, images, ref = sec_pair
    out = port.eval_forward(torch.from_numpy(images)).numpy()
    assert_close(out, ref, 1e-4)
    with torch.no_grad():  # the first head's logits differ
        feats = port.backbone_forward(torch.from_numpy(images))["output_features"]
        assert not torch.allclose(port.sem_seg_head(feats), port.sem_seg_head_sec_modal(feats))


@pytest.mark.parametrize("mode", ["aspp", "full", "argmax", "none"])
def test_second_head_kernel_eval_ids_read_its_weights(sec_pair, mode):
    """The kernel heads (their CPU twins) on the second head's weights give
    JAX's argmax on every sure pixel."""
    port, images, ref = sec_pair
    ids = port.eval_forward_ids(torch.from_numpy(images), eval_head=mode).numpy()
    sure = sure_pixels(ref)
    assert sure.mean() > 0.9
    assert (ids[sure] == ref.argmax(-1)[sure]).all()


def test_variant_checkpoint_keys_round_trip(tmp_path):
    """A model with every head and prompt variant: its released-layout
    state dict (``reference_state_dict``) converts back key for key
    (``convert_madm_pth``: ISA ``fuse_layer.*``, ``vae_decoder_feat_proj.*``,
    the second head, [16, 1, S, 768] prompts), and the port's own
    checkpoint (the tower too) loads back equal."""
    cfg = MADMConfig(**TOY, compute_dtype=torch.float32, head_fusion="isa", final_fuse_vae_decoder_feat=True,
                     sem_seg_head_sec_modal=True, multi_layer_prompt=True, concat_pixel_shuffle=True)
    src = init_random_(MADM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    ref = reference_state_dict(src)
    assert any(k.startswith("sem_seg_head.vae_decoder_feat_proj.0.") for k in ref)
    assert any(k.startswith("sem_seg_head.fuse_layer.global_relation.query_project.1.") for k in ref)
    assert any(k.startswith("sem_seg_head_sec_modal.") for k in ref)
    torch.save(ref, tmp_path / "released.pth")
    dst = init_random_(MADM(cfg, device="cpu"), torch.Generator().manual_seed(1))
    merge_into_model(dst, convert_madm_pth(str(tmp_path / "released.pth")))
    own, back = src.state_dict(), dst.state_dict()
    moved = [k for k in own if k.startswith(("sem_seg_head", "prompt.", "feature_projections."))]
    assert moved and all(torch.equal(own[k], back[k]) for k in moved)
    assert back["prompt.clip_project_rgb.prompt_embed"].shape == (16, 1, 77, 768)
    torch.save(src.state_dict(), tmp_path / "own.pth")
    dst.load_state_dict(torch.load(tmp_path / "own.pth", weights_only=True))
    assert all(torch.equal(own[k], dst.state_dict()[k]) for k in own)
    assert any(k.startswith("pixel_unshuffle.") for k in own)
