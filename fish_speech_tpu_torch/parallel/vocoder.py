"""The vocoder over the data axis of a mesh.

Counterpart of `__graft_entry__._dryrun_vocoder` in the JAX package,
which decodes a code batch placed on `P(DATA_AXIS)` with the codec's
weights replicated (the vocoder has no model-axis sharding: its weights
are small, so every rank holds them whole). Here every rank decodes its
data rows and the waveforms are gathered back.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, gather_batch, shard_batch


def decode_data_parallel(codec_params: dict, codec_cfg, codes: torch.Tensor,
                         mesh: Mesh, packed: dict | None = None
                         ) -> torch.Tensor:
    """Codes (B, K+1, T), the same whole batch on every rank, -> the
    waveform (B, T * frame_length), whole on every rank. The rank decodes
    `shard_batch` of the codes: on a CUDA device through the serving
    route's fused decoder (#3 `voc_block`, #4 `voc_res_stack`; `packed`:
    its `pack_decoder`, made per call when None), on the CPU through the
    plain `codec.model.dac_from_indices`."""
    local = shard_batch(codes, mesh).to(mesh.device)
    if mesh.device.type == "cuda":
        from ..codec.fastpath import dac_from_indices_fused

        wav = dac_from_indices_fused(codec_params, codec_cfg, local,
                                     packed=packed, device=mesh.device)
    else:
        from ..codec.model import dac_from_indices

        wav = dac_from_indices(codec_params, codec_cfg, local)
    return gather_batch(wav.contiguous(), mesh)
