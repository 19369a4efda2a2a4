"""Architecture configurations (port of ``repro.configs``): ``base`` (its
recsys part), the four recsys architectures (``autoint``, ``dcn_v2``,
``dien``, ``dlrm_mlperf``) and the paper's own ``lpq_ann``.  Copied, not
imported: the port imports nothing of the reference package."""
