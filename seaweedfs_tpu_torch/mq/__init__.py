"""Message queue, after upstream's weed/mq/ (log-structured topic broker
on the filer).

Topics are partitioned append-only logs. Hot tails live in LogBuffers
(seaweedfs_tpu_torch.utils.log_buffer); full
segments persist as filer files under

    /topics/<namespace>/<topic>/<partition>/<first_ts_ns>.seg

so the broker is stateless across restarts: subscribers seeking back in
time read flushed segments from the filer, then continue on the live
buffer — the reference broker's read path shape.
"""

from seaweedfs_tpu_torch.mq.broker import Broker, BrokerClient

__all__ = ["Broker", "BrokerClient"]
