"""Utility subsystems: profiling, progress reporting, logging, tracing.

Reference parity: ohmutil/Profile, ohmutil/ProgressMonitor, logutil/, and
ohm/Trace (visual debug stream, here a structured JSONL event log).
"""

from ohm_tpu_torch.utils.profile import Profile, ProfileMarker, profile_marker
from ohm_tpu_torch.utils.progress import ProgressMonitor
from ohm_tpu_torch.utils.log import get_logger, set_log_level
from ohm_tpu_torch.utils.trace import Trace
