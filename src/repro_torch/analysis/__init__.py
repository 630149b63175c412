"""Per-rank cost of a traced step (``counter``): the port's twin of
``repro.analysis``, read by the dry run (``launch.dryrun``)."""
