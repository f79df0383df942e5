"""Device-resident accumulator services: the merged word/count table the
streaming word count folds into (``table``), its sync cadence
(``policy``), and the streaming grep's top-k and histogram (``topk``)."""

from dsi_tpu_torch.device.policy import SyncPolicy, sync_every_default
from dsi_tpu_torch.device.table import DeviceTable

__all__ = ["DeviceTable", "SyncPolicy", "sync_every_default"]
