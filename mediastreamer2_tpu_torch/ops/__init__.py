"""Filter library: importing this package registers the port's filters."""

from mediastreamer2_tpu_torch.ops import boundary  # noqa: F401
from mediastreamer2_tpu_torch.ops import resample  # noqa: F401
from mediastreamer2_tpu_torch.ops import volume    # noqa: F401
from mediastreamer2_tpu_torch.ops import mixer     # noqa: F401
from mediastreamer2_tpu_torch.ops import aec       # noqa: F401
from mediastreamer2_tpu_torch.ops import g711      # noqa: F401
from mediastreamer2_tpu_torch.ops import g722      # noqa: F401
from mediastreamer2_tpu_torch.ops import misc      # noqa: F401
from mediastreamer2_tpu_torch.ops import plc       # noqa: F401
from mediastreamer2_tpu_torch.ops import fileio    # noqa: F401
from mediastreamer2_tpu_torch.ops import tones     # noqa: F401
from mediastreamer2_tpu_torch.ops import vad       # noqa: F401
from mediastreamer2_tpu_torch.ops import eq        # noqa: F401
from mediastreamer2_tpu_torch.ops import video     # noqa: F401
from mediastreamer2_tpu_torch.ops import flowcontrol  # noqa: F401
from mediastreamer2_tpu_torch.ops import baudot    # noqa: F401
from mediastreamer2_tpu_torch.ops import adpcm     # noqa: F401
from mediastreamer2_tpu_torch.ops import g726      # noqa: F401
