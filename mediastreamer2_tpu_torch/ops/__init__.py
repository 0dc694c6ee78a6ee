"""Filter library: importing this package registers the port's filters."""

from mediastreamer2_tpu_torch.ops import boundary  # noqa: F401
from mediastreamer2_tpu_torch.ops import resample  # noqa: F401
from mediastreamer2_tpu_torch.ops import volume    # noqa: F401
from mediastreamer2_tpu_torch.ops import mixer     # noqa: F401
from mediastreamer2_tpu_torch.ops import aec       # noqa: F401
