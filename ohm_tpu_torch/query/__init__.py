"""Map queries of the port (counterpart of ``ohm_tpu.query``; reference:
ohm/Query*, ohmgpu/*QueryGpu, ohmgpu/ClearanceProcess).

``RaysQuery``, ``LineKeysQuery`` and ``ClearanceProcess`` run their device
parts in PyTorch on a ``device`` ("cuda" by default; "cpu" when asked);
``NearestNeighbours``, ``LineQuery`` and ``AsyncQueryMixin`` are numpy
copies of their namesakes (``LineQuery`` builds a ``ClearanceProcess`` on
its default device).
"""

from ohm_tpu_torch.query.rays_query import RaysQuery, OccupancyType
from ohm_tpu_torch.query.line_keys import LineKeysQuery
from ohm_tpu_torch.query.nearest import NearestNeighbours
from ohm_tpu_torch.query.line_query import LineQuery
from ohm_tpu_torch.query.clearance import ClearanceProcess
from ohm_tpu_torch.query.base import AsyncQueryMixin
