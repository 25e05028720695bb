"""Small host utilities of the port (``utils/network.py``: the reference's
``nic_name_to_host`` and ``start_local_nameserver``)."""

from hpbandster_tpu_torch.utils.network import (  # noqa: F401
    nic_name_to_host,
    start_local_nameserver,
)
