"""The port's distributed pieces: the sharding rules and their DTensor
binding (``sharding.py``), deterministic collectives (``comm.py``),
elastic re-meshing (``elastic.py``), gradient compression
(``compression.py``), the GPipe pipeline (``pipeline.py``) and the
straggler monitor (``straggler.py``).  Importing them touches no process
group."""
