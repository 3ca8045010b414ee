"""Port int8 row quantization vs the JAX one: bit-equal bytes and scales,
including all-zero rows (scale 0), tiny rows and exact .5 ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_rag_colbertv2_tpu.ops.quant import (
    dequantize_int8_rows as jax_dq, quantize_int8_rows as jax_q)
from hybrid_rag_colbertv2_tpu_torch.ops.quant import (
    dequantize_int8_rows, quantize_int8_rows)


def _rows(seed, scale):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2048, 128)) * scale).astype(np.float32)
    x[3] = 0.0                                  # padding row
    x[9, :] = 1e-30                             # tiny, uniform row
    x[17, :4] = [127.0, 0.5, -0.5, 1.5]         # absmax 127: .5 ties
    x[17, 4:] = 0.0
    return x


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 50.0)])
def test_quantize_int8_rows_bit_equal(seed, scale):
    x = _rows(seed, scale)
    jq, js = jax_q(jnp.asarray(x))
    tq, ts = quantize_int8_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js).view(np.uint32),
                          ts.numpy().view(np.uint32))
    assert ts[3].item() == 0.0 and (tq[3] == 0).all()
    jd = np.asarray(jax_dq(jq, js))
    td = dequantize_int8_rows(tq, ts).numpy()
    assert np.array_equal(jd.view(np.uint32), td.view(np.uint32))
