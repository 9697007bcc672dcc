"""Serialisation and point-cloud ingestion.

Reference parity: ohm/MapSerialise*, ohm/Stream (the .ohm format) and
slamio/ (cloud + trajectory loading).
"""

from ohm_tpu_torch.io.serialise import save, load, load_header, MapValue, SerialisationError
