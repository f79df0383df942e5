"""Device-resident accumulator services: the merged word/count table the
streaming word count folds into (``table``), its sync cadence
(``policy``), the streaming grep's top-k and histogram (``topk``), and
the TF-IDF wave walk's postings buffer (``postings``)."""

from dsi_tpu_torch.device.policy import SyncPolicy, sync_every_default
from dsi_tpu_torch.device.postings import DevicePostings
from dsi_tpu_torch.device.table import DeviceTable

__all__ = ["DevicePostings", "DeviceTable", "SyncPolicy",
           "sync_every_default"]
