"""The port's engineered-text-prompt path against the JAX package's on
CPU: ``format_prompt``, the residual ``TextAdapter`` (a JAX init carried
into the port, the port's seeded init carried into JAX; gamma at its 1e-4
and at 1, where the MLP's part is not lost under fp32 rounding), and
``embed_prompts`` through SD-v1.4's full-width text encoder on numpy
weights.  fp32, held to 1e-5 of max(1, max|reference|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madm_tpu.checkpoint.converter import convert_clip_text_state
from madm_tpu.models import text_prompt as jtp
from madm_torch.models import clip_text as pclip
from madm_torch.models import text_prompt as ptp
from test_torch_clip_text import hf_state
from torch_port_toy import assert_close

TOL = 1e-5


@pytest.mark.parametrize("names", [[], ["Road"], ["road", "Car"], ["road", "car", "Sky", "person"]])
@pytest.mark.parametrize("template", [ptp.DEFAULT_SOURCE_TEXT, ptp.DEFAULT_TARGET_TEXT,
                                      ptp.DEFAULT_MIXUP_TEXT])
def test_format_prompt_matches_jax(template, names):
    assert ptp.format_prompt(template, names) == jtp.format_prompt(template, names)
    assert (ptp.DEFAULT_SOURCE_TEXT, ptp.DEFAULT_TARGET_TEXT, ptp.DEFAULT_MIXUP_TEXT) == (
        jtp.DEFAULT_SOURCE_TEXT, jtp.DEFAULT_TARGET_TEXT, jtp.DEFAULT_MIXUP_TEXT)


def _jax_params(adapter):
    return {"fc1": {"kernel": jnp.asarray(adapter.fc1.weight.detach().numpy().T),
                    "bias": jnp.asarray(adapter.fc1.bias.detach().numpy())},
            "fc2": {"kernel": jnp.asarray(adapter.fc2.weight.detach().numpy().T),
                    "bias": jnp.asarray(adapter.fc2.bias.detach().numpy())},
            "gamma": jnp.asarray(adapter.gamma.detach().numpy())}


def _texts():
    return np.random.default_rng(0).standard_normal((2, 77, 64)).astype(np.float32)


@pytest.mark.parametrize("gamma", [1e-4, 1.0])
@pytest.mark.parametrize("hidden", [None, 32])
def test_text_adapter_from_a_jax_init_matches_jax(gamma, hidden):
    params = jtp.init_text_adapter(jax.random.PRNGKey(0), 64, hidden, gamma)
    port = ptp.TextAdapter(64, hidden, gamma)
    port.load_state_dict({"fc1.weight": torch.from_numpy(np.asarray(params["fc1"]["kernel"]).T),
                          "fc1.bias": torch.from_numpy(np.asarray(params["fc1"]["bias"])),
                          "fc2.weight": torch.from_numpy(np.asarray(params["fc2"]["kernel"]).T),
                          "fc2.bias": torch.from_numpy(np.asarray(params["fc2"]["bias"])),
                          "gamma": torch.from_numpy(np.asarray(params["gamma"]))}, strict=True)
    ref = jtp.text_adapter(params, jnp.asarray(_texts()))
    with torch.no_grad():
        out = port(torch.from_numpy(_texts()))
    assert_close(out, ref, TOL)


@pytest.mark.parametrize("gamma", [1e-4, 1.0])
def test_text_adapter_from_a_port_init_matches_jax(gamma):
    """The port's seeded init (JAX's distribution: U(+-1/sqrt(fan_in)), zero
    biases, gamma filled) carried into JAX's ``text_adapter``."""
    port = ptp.init_text_adapter(torch.Generator().manual_seed(1), 64, 48, gamma)
    for fc in (port.fc1, port.fc2):
        assert fc.weight.abs().max() <= fc.in_features ** -0.5 and not fc.bias.any()
    assert torch.equal(port.gamma, torch.full((64,), gamma))
    ref = jtp.text_adapter(_jax_params(port), jnp.asarray(_texts()))
    with torch.no_grad():
        out = port(torch.from_numpy(_texts()))
    assert_close(out, ref, TOL)


def test_embed_prompts_matches_jax():
    """Two tokenised prompts through SD-v1.4's text encoder at full width
    (49408 x 768, 12 layers, 12 heads, MLP 3072) on numpy weights."""
    sd = hf_state(pclip.VOCAB_SIZE, pclip.WIDTH, pclip.LAYERS, pclip.MLP_DIM, pclip.MAX_LEN, seed=7)
    ids = np.full((2, 77), pclip.EOS_ID, np.int64)
    ids[:, 0] = pclip.BOS_ID
    ids[:, 1:9] = np.random.default_rng(8).integers(0, 49000, (2, 8))
    ref = jtp.embed_prompts(convert_clip_text_state(sd), jnp.asarray(ids, jnp.int32))
    model = pclip.load_clip_text({k: torch.from_numpy(v) for k, v in sd.items()}, device="cpu")
    out = ptp.embed_prompts(model, torch.from_numpy(ids))
    assert out.shape == (2, 77, 768)
    assert_close(out, ref, TOL)
