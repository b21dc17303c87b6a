"""Convert reference (torch) codec checkpoints into the port's codec tree.

Counterpart of `fish_speech_tpu/codec/convert.py`. The input is a flat
{name: tensor or numpy array} state dict in the reference module naming
(modded_dac.py, rvq.py and the descript-audio-codec quantizer submodules);
the output is the tree codec/model.py and codec/rvq.py read, the one
`codec.init.init_dac_params` draws and `codec_params_from_jax` carries.

Layout transforms, applied once here:
- weight-norm parametrizations are folded: w = g * v / ||v|| (the norm over
  all dims but 0, summed in float64 as the JAX package does);
- Conv1d (out, in/g, k) -> (k, in/g, out);
- ConvTranspose1d (in, out, k) -> (k, in, out) with the spatial axis
  flipped;
- ConvNeXt pointwise Linear weights -> (in, out); attention and FFN
  weights keep the torch (out, in) layout;
- Snake alpha (1, C, 1) -> (C,);
- per-codebook in/out projections and codebooks stacked on a leading axis.
Every leaf is f32 on the requested device.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..utils.checkpoint import sd_tensor
from .config import DACConfig, RVQConfig


def _fold_weight_norm(sd: dict, prefix: str) -> torch.Tensor:
    """The plain kernel of a torch weight_norm parametrization (or the
    plain weight), in the dtype of its direction."""
    g_key = f"{prefix}.parametrizations.weight.original0"
    if g_key in sd:
        g = sd_tensor(sd[g_key])
        v = sd_tensor(sd[f"{prefix}.parametrizations.weight.original1"])
        vd = v.double()
        dims = tuple(range(1, v.ndim))
        norm = vd.square().sum(dim=dims, keepdim=True).sqrt()
        return (g.double() * (vd / norm)).to(v.dtype)
    return sd_tensor(sd[f"{prefix}.weight"])


class _Out:
    """Moves converted leaves to the device as f32."""

    def __init__(self, device):
        self.device = device

    def __call__(self, v):
        if v is None:
            return None
        return sd_tensor(v).to(device=self.device, dtype=torch.float32).contiguous()


def _conv(sd: dict, prefix: str, out: _Out) -> dict:
    """CausalConvNet / WNConv1d at `prefix` (the inner nn.Conv1d is
    `.conv` for CausalConvNet; a plain WNConv1d has the weight directly)."""
    inner = (f"{prefix}.conv"
             if f"{prefix}.conv.bias" in sd
             or f"{prefix}.conv.parametrizations.weight.original0" in sd
             or f"{prefix}.conv.weight" in sd else prefix)
    w = _fold_weight_norm(sd, inner)
    return {"w": out(w.permute(2, 1, 0)), "b": out(sd.get(f"{inner}.bias"))}


def _conv_transpose(sd: dict, prefix: str, out: _Out) -> dict:
    inner = (f"{prefix}.conv"
             if any(k.startswith(f"{prefix}.conv.") for k in sd) else prefix)
    w = _fold_weight_norm(sd, inner)                     # (in, out, k)
    w = w.permute(2, 0, 1).flip(0)                       # (k, in, out)
    return {"w": out(w), "b": out(sd.get(f"{inner}.bias"))}


def _snake(sd: dict, prefix: str, out: _Out) -> torch.Tensor:
    return out(sd_tensor(sd[f"{prefix}.alpha"]).reshape(-1))


def _convnext(sd: dict, prefix: str, out: _Out) -> dict:
    dw = _conv(sd, f"{prefix}.dwconv", out)
    p = {
        "dwconv_w": dw["w"], "dwconv_b": dw["b"],
        "norm_w": out(sd[f"{prefix}.norm.weight"]),
        "norm_b": out(sd[f"{prefix}.norm.bias"]),
        "pw1_w": out(sd_tensor(sd[f"{prefix}.pwconv1.weight"]).T),
        "pw1_b": out(sd[f"{prefix}.pwconv1.bias"]),
        "pw2_w": out(sd_tensor(sd[f"{prefix}.pwconv2.weight"]).T),
        "pw2_b": out(sd[f"{prefix}.pwconv2.bias"]),
    }
    if f"{prefix}.gamma" in sd:
        p["gamma"] = out(sd[f"{prefix}.gamma"])
    return p


def _transformer(sd: dict, prefix: str, n_layer: int, out: _Out) -> dict:
    layers = []
    for i in range(n_layer):
        lp = f"{prefix}.layers.{i}"
        layers.append({
            "attention": {
                "wqkv": out(sd[f"{lp}.attention.wqkv.weight"]),
                "wo": out(sd[f"{lp}.attention.wo.weight"]),
            },
            "feed_forward": {
                "w1": out(sd[f"{lp}.feed_forward.w1.weight"]),
                "w2": out(sd[f"{lp}.feed_forward.w2.weight"]),
                "w3": out(sd[f"{lp}.feed_forward.w3.weight"]),
            },
            "attention_norm": out(sd[f"{lp}.attention_norm.weight"]),
            "ffn_norm": out(sd[f"{lp}.ffn_norm.weight"]),
            "attention_ls": out(sd[f"{lp}.attention_layer_scale.gamma"]),
            "ffn_ls": out(sd[f"{lp}.ffn_layer_scale.gamma"]),
        })
    p = {"layers": layers, "norm": out(sd[f"{prefix}.norm.weight"])}
    if f"{prefix}.input_proj.weight" in sd:
        p["input_proj_w"] = out(sd[f"{prefix}.input_proj.weight"])
        p["input_proj_b"] = out(sd[f"{prefix}.input_proj.bias"])
    if f"{prefix}.output_proj.weight" in sd:
        p["output_proj_w"] = out(sd[f"{prefix}.output_proj.weight"])
        p["output_proj_b"] = out(sd[f"{prefix}.output_proj.bias"])
    return p


def _residual_unit(sd: dict, prefix: str, out: _Out) -> dict:
    c1 = _conv(sd, f"{prefix}.block.1", out)
    c2 = _conv(sd, f"{prefix}.block.3", out)
    return {
        "snake1_alpha": _snake(sd, f"{prefix}.block.0", out),
        "conv1_w": c1["w"], "conv1_b": c1["b"],
        "snake2_alpha": _snake(sd, f"{prefix}.block.2", out),
        "conv2_w": c2["w"], "conv2_b": c2["b"],
    }


def _vq_stack(sd: dict, prefix: str, n: int, out: _Out) -> tuple:
    """The n per-codebook quantizers under `prefix.quantizers.{i}`,
    stacked: (codebooks, in_w (n, D, d), in_b, out_w (n, d, D), out_b)."""
    cbs, in_w, in_b, out_w, out_b = [], [], [], [], []
    for i in range(n):
        qp = f"{prefix}.quantizers.{i}"
        cbs.append(sd_tensor(sd[f"{qp}.codebook.weight"]))
        iw = _fold_weight_norm(sd, f"{qp}.in_proj")       # (d, D, 1)
        ow = _fold_weight_norm(sd, f"{qp}.out_proj")      # (D, d, 1)
        in_w.append(iw[..., 0].T)                         # (D, d)
        in_b.append(sd_tensor(sd[f"{qp}.in_proj.bias"]))
        out_w.append(ow[..., 0].T)                        # (d, D)
        out_b.append(sd_tensor(sd[f"{qp}.out_proj.bias"]))
    return tuple(out(torch.stack(x)) for x in (cbs, in_w, in_b, out_w, out_b))


def convert_quantizer(sd: dict, cfg: RVQConfig, prefix: str = "quantizer",
                      device=None) -> dict:
    out = _Out(resolve_device(device))
    sem = _vq_stack(sd, f"{prefix}.semantic_quantizer", 1, out)
    res = _vq_stack(sd, f"{prefix}.quantizer", cfg.n_codebooks, out)
    params = {
        "semantic_codebooks": sem[0], "semantic_in_w": sem[1],
        "semantic_in_b": sem[2], "semantic_out_w": sem[3],
        "semantic_out_b": sem[4],
        "residual_codebooks": res[0], "residual_in_w": res[1],
        "residual_in_b": res[2], "residual_out_w": res[3],
        "residual_out_b": res[4],
        "downsample": [], "upsample": [],
    }
    for i in range(len(cfg.downsample_factor)):
        c = _conv(sd, f"{prefix}.downsample.{i}.0", out)
        params["downsample"].append({
            "conv_w": c["w"], "conv_b": c["b"],
            "convnext": _convnext(sd, f"{prefix}.downsample.{i}.1", out),
        })
        ct = _conv_transpose(sd, f"{prefix}.upsample.{i}.0", out)
        params["upsample"].append({
            "conv_w": ct["w"], "conv_b": ct["b"],
            "convnext": _convnext(sd, f"{prefix}.upsample.{i}.1", out),
        })
    t = cfg.pre_post_transformer
    params["pre_module"] = _transformer(sd, f"{prefix}.pre_module",
                                        t.n_layer, out)
    params["post_module"] = _transformer(sd, f"{prefix}.post_module",
                                         t.n_layer, out)
    return params


def convert_encoder(sd: dict, cfg: DACConfig, prefix: str = "encoder",
                    device=None) -> dict:
    out = _Out(resolve_device(device))
    cin = _conv(sd, f"{prefix}.block.0", out)
    params = {"conv_in_w": cin["w"], "conv_in_b": cin["b"], "blocks": []}
    n_blocks = len(cfg.encoder_rates)
    for bi in range(n_blocks):
        bp = f"{prefix}.block.{bi + 1}.block"
        strided = _conv(sd, f"{bp}.4", out)
        block = {
            "res_units": [_residual_unit(sd, f"{bp}.{u}", out)
                          for u in range(3)],
            "snake_alpha": _snake(sd, f"{bp}.3", out),
            "conv_w": strided["w"], "conv_b": strided["b"],
        }
        n_t = cfg.encoder_transformer_layers[bi]
        if n_t > 0:
            block["transformer"] = _transformer(sd, f"{bp}.5", n_t, out)
        params["blocks"].append(block)
    cout = _conv(sd, f"{prefix}.block.{n_blocks + 2}", out)
    params["snake_alpha"] = _snake(sd, f"{prefix}.block.{n_blocks + 1}", out)
    params["conv_out_w"] = cout["w"]
    params["conv_out_b"] = cout["b"]
    return params


def convert_decoder(sd: dict, cfg: DACConfig, prefix: str = "decoder",
                    device=None) -> dict:
    out = _Out(resolve_device(device))
    cin = _conv(sd, f"{prefix}.model.0", out)
    params = {"conv_in_w": cin["w"], "conv_in_b": cin["b"], "blocks": []}
    n_blocks = len(cfg.decoder_rates)
    for bi in range(n_blocks):
        bp = f"{prefix}.model.{bi + 1}.block"
        ct = _conv_transpose(sd, f"{bp}.1", out)
        params["blocks"].append({
            "snake_alpha": _snake(sd, f"{bp}.0", out),
            "conv_w": ct["w"], "conv_b": ct["b"],
            "res_units": [_residual_unit(sd, f"{bp}.{u}", out)
                          for u in (2, 3, 4)],
        })
    cout = _conv(sd, f"{prefix}.model.{n_blocks + 2}", out)
    params["snake_alpha"] = _snake(sd, f"{prefix}.model.{n_blocks + 1}", out)
    params["conv_out_w"] = cout["w"]
    params["conv_out_b"] = cout["b"]
    return params


def convert_dac_state_dict(sd: dict, cfg: DACConfig, device=None) -> dict:
    """The whole codec: {"encoder", "quantizer", "decoder"} on `device`
    (CUDA unless named). A 'generator.' prefix is stripped."""
    device = resolve_device(device)
    sd = {k[len("generator."):] if k.startswith("generator.") else k: v
          for k, v in sd.items()}
    return {
        "encoder": convert_encoder(sd, cfg, device=device),
        "quantizer": convert_quantizer(sd, cfg.rvq, device=device),
        "decoder": convert_decoder(sd, cfg, device=device),
    }
