"""Sharding rules (``sharding``), the ambient sharding context models read
(``context``), and the data-parallel BNS step's collectives (through
``core.bns.make_distributed_bns_step``). Port of ``repro.distributed``,
without ``emulate``: splitting one CPU into many devices is XLA's, and a
torch process group stands in for it (``launch.mesh``)."""
