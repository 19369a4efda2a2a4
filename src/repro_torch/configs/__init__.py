"""Architecture configurations (port of ``repro.configs``, the recsys part
that the ported paths read: ``base`` and ``dlrm_mlperf``).  Copied, not
imported: the port imports nothing of the reference package."""
