"""K2's fp32 beam form (csrc/decode_attention_beam.cu `beam_f32_kernel`): its
grid on the CPU. `beam_plan` with fp32 q gives every (group, head, beam,
key) to exactly one CTA: tiles of `beam_f32_rows` beams (at most 8, as even
as they can be: 17 beams take 6, 6 and 5), key shares of whole rounds of
four 32-key chunks over a cluster of at most 8 CTAs, no empty share, the
chunks of a share dealt to its four warps in turn. tests/test_torch_fp32.py
holds the grid at beam search's shape and the walk in its order to JAX's.
"""
import numpy as np
import pytest
import torch

from kotoba_whisper_tpu_torch.ops import decode_attention as da

@pytest.mark.parametrize("t", [1, 63, 1500])
@pytest.mark.parametrize("beams", [1, 5, 8, 16, 17])
def test_f32_beam_plan_covers_each_key_once(beams, t):
    n_heads = 20
    for g in (1, 2, 12):
        plan = da.beam_plan(g, t, n_heads, beams, torch.float32, q_dtype=torch.float32)
        splits, y_dim, z_dim = plan.grid
        rows = da.beam_f32_rows(beams)
        assert rows <= da.BEAM_F32_ROWS and plan.m_tiles == -(-beams // da.BEAM_F32_ROWS)
        assert (plan.m_tiles - 1) * rows < beams <= plan.m_tiles * rows
        assert (y_dim, z_dim) == (n_heads * plan.m_tiles, g) and splits == plan.splits
        assert 1 <= splits <= da.MAX_CLUSTER
        assert plan.keys_per_split % (da.BEAM_F32_CHUNK * da.BEAM_F32_WARPS) == 0
        assert (splits - 1) * plan.keys_per_split < t <= splits * plan.keys_per_split
        seen = np.zeros((g, n_heads, beams, t), np.int64)
        for x in range(splits):
            k0 = x * plan.keys_per_split
            k1 = min(t, k0 + plan.keys_per_split)
            assert k1 > k0
            n_chunks = -(-(k1 - k0) // da.BEAM_F32_CHUNK)
            dealt = sorted(c for w in range(da.BEAM_F32_WARPS)
                           for c in range(w, n_chunks, da.BEAM_F32_WARPS))
            assert dealt == list(range(n_chunks))
            for y in range(y_dim):
                h, mt = y % n_heads, y // n_heads
                for z in range(z_dim):
                    seen[z, h, mt * rows:min(beams, (mt + 1) * rows), k0:k1] += 1
        assert (seen == 1).all()
