"""On-card measurement probes: the TPU micro-benchmarks of ``scripts/``
asked again of Hopper kernels.

Each module builds its script's input from the script's seed, launches a
hand-written kernel (:mod:`graph_tpu_torch.probes.kernels` for K1's
gather probes, :mod:`graph_tpu_torch.probes.k2_kernels` for K2's stream
probes, :mod:`graph_tpu_torch.probes.k2_stage_kernels` for K2's stage
probes), holds it against its plain version and prints the script's
lines (ms, ns/slot, exactness; the K2 probes also GB/s by the bytes the
kernel moves and, on a card, the card's own time a call).  They run on
the card unless given ``--device cpu``:

    python -m graph_tpu_torch.probes.k1_lanemap    # depth probe, lanemap
    python -m graph_tpu_torch.probes.k1_rowmatch [win ...]
    python -m graph_tpu_torch.probes.k1_sublane [win ...]
    python -m graph_tpu_torch.probes.k2_io [--nsec N] [--passes R]
    python -m graph_tpu_torch.probes.k2_io2 [scale] [relabel]
    python -m graph_tpu_torch.probes.k2_io3 [scale] [relabel]
    python -m graph_tpu_torch.probes.k2_io4 [scale]
    python -m graph_tpu_torch.probes.k2_io5 [scale]
    python -m graph_tpu_torch.probes.k2_streams [nsec]
    python -m graph_tpu_torch.probes.k2_stages [--nsec N] [--passes R]
    python -m graph_tpu_torch.probes.k2v2_stages [scale] [relabel]
    python -m graph_tpu_torch.probes.k2_route_ops [scale] [relabel]
    python -m graph_tpu_torch.probes.k2_sec128 [nsec512]
    python -m graph_tpu_torch.probes.transpose [--nsec N]

The K1 probes' sizes follow the scripts: blocks of 16,384 slots (128 rows
of 128 lanes), 256 of them by default (``--blocks``).  The K2 probes run
the scripts' sizes: 512 synthetic sections (200 passes a launch for
``k2_io``, 150 for ``k2_stages``), the section layout of RMAT (default
scale 22, degree relabel; :mod:`graph_tpu_torch.probes.k2_layout`), or a
routed stand-in for the TPU plan's sections of it
(:mod:`graph_tpu_torch.probes.k2_routes`), 1,024 sections
(``k2_streams``), 8 + 32 ``gen_keys`` sections (``k2_sec128``), 128
blocks (``transpose``).
"""

#: Slots of a script's block: 16 tiles of 8 rows x 128 lanes.
TILE = 1024
TPB = 16
BLK = TILE * TPB
#: The scripts' block count (4,194,304 slots), and K1's slot count at
#: RMAT scale 22 in blocks (67,108,864 slots).
NBLK = 256
K1_NBLK = 4096
