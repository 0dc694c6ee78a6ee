"""mediastreamer2_tpu_torch -- the PyTorch + CUDA port of mediastreamer2_tpu.

The same media engine as the JAX package beside it, for one NVIDIA H100:
call legs are rows of a ``[legs, samples]`` tick block, a filter graph runs
one ``step`` per 10 ms tick for all legs, and the kernels that the JAX
package wrote in Pallas for the TPU are hand-written CUDA for Hopper
(``csrc/``, built at first use by ``ops/kernels.py``).

This package imports torch and never jax; the JAX package stays the
reference that the tests hold it to. Layout and names mirror the JAX
package's:

* :mod:`mediastreamer2_tpu_torch.core`   -- formats, filters, factory, graph,
  the ticker and event queue, worker pools, paced-section GC
* :mod:`mediastreamer2_tpu_torch.ops`    -- the filters (G.711, G.722, PLC,
  mixers, tones, VAD, ...) and the kernels
* :mod:`mediastreamer2_tpu_torch.models` -- the flagship leg, the end-to-end
  G.711 conference bench over UDP, the audio stream session
  (``AudioStreamBatch``), the conference control and the QoS controllers
* :mod:`mediastreamer2_tpu_torch.native` -- the batched RTP edge with inline
  SRTP, and the AES the port's SRTP uses (C++, g++)
* :mod:`mediastreamer2_tpu_torch.net`    -- RTP sessions and transports, SRTP,
  RTCP, bandwidth estimators, jitter buffers, the edge's jitter controller
* :mod:`mediastreamer2_tpu_torch.utils`  -- tree conversion, audio oracle,
  test signals, JAX's threefry random numbers
"""

__version__ = "0.1.0"

from mediastreamer2_tpu_torch.core.block import TICK_MS, Format, tick_samples  # noqa: F401
from mediastreamer2_tpu_torch.core.filter import FilterDef, FilterCtx, register_filter  # noqa: F401
from mediastreamer2_tpu_torch.core.factory import Factory  # noqa: F401
from mediastreamer2_tpu_torch.core.graph import GraphBuilder  # noqa: F401
from mediastreamer2_tpu_torch.models.flagship import build_flagship  # noqa: F401
from mediastreamer2_tpu_torch.models.e2e_bench import (  # noqa: F401
    E2EConferenceBench, build_e2e_graph)
