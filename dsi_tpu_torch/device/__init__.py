"""Device-resident accumulator service: the merged word/count table the
streaming word count folds into (``table``) and its sync cadence
(``policy``)."""

from dsi_tpu_torch.device.policy import SyncPolicy, sync_every_default
from dsi_tpu_torch.device.table import DeviceTable

__all__ = ["DeviceTable", "SyncPolicy", "sync_every_default"]
