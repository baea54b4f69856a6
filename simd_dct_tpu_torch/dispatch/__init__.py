"""Backend tiers and the capability probe."""

from .capability import (TIERS, DeviceInfo, available_tiers, default_device,
                         get_max_backend, probe, select_backend,
                         set_max_backend)
