"""PyTorch port, quantized execution: the paged layout's cases of
``test_quantized_engine_streams_equal_jax`` (``test_torch_port_quant.py`` holds the
contiguous layout's and the rest of the slice's tests; the tolerances are stated there:
greedy streams token for token, a divergence allowed only at a true tie). Both halves of
the one test build a JAX engine a case, so they sit in two files that two test workers
run side by side.
"""

import pytest

from test_torch_port_quant import CONFIG_IDS, CONFIGS, check_engine_streams


@pytest.mark.parametrize("layout", ["paged"])
@pytest.mark.parametrize("policy", ["off", "w8", "w8a8"])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_quantized_engine_streams_equal_jax(cfg, kv, policy, layout):
    """Four requests through 3 slots (slots and pages freed and reused mid-stream), pages
    of 8: the streams (up to true ties), the counters, the byte accounting and the
    allocator's ledger after the run are the JAX engine's."""
    check_engine_streams(cfg, kv, policy, layout)
