"""Test/demo map generators and cloud export (reference: ohmtools/)."""

from ohm_tpu_torch.tools.gen import fill_map_with_empty_space, box_room, slope
from ohm_tpu_torch.io.ply import save_cloud_ply
