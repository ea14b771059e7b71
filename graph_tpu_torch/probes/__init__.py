"""On-card measurement probes: the TPU micro-benchmarks of ``scripts/``
asked again of Hopper kernels.

Each module builds its script's input from the script's seed, launches a
hand-written kernel (:mod:`graph_tpu_torch.probes.kernels` for K1's
gather probes, :mod:`graph_tpu_torch.probes.k2_kernels` for K2's stream
probes), holds it against its plain version and prints the script's
lines (ms, ns/slot, exactness; the K2 probes also GB/s by the script's
bytes and by the bytes the kernel moves).  They run on the card unless
given ``--device cpu``:

    python -m graph_tpu_torch.probes.k1_lanemap    # depth probe, lanemap
    python -m graph_tpu_torch.probes.k1_rowmatch [win ...]
    python -m graph_tpu_torch.probes.k1_sublane [win ...]
    python -m graph_tpu_torch.probes.k2_io [--nsec N] [--passes R]
    python -m graph_tpu_torch.probes.k2_io2 [scale] [relabel]
    python -m graph_tpu_torch.probes.k2_io3 [scale] [relabel]
    python -m graph_tpu_torch.probes.k2_io4 [scale]
    python -m graph_tpu_torch.probes.k2_io5 [scale]
    python -m graph_tpu_torch.probes.k2_streams [nsec]

The K1 probes' sizes follow the scripts: blocks of 16,384 slots (128 rows
of 128 lanes), 256 of them by default (``--blocks``).  The K2 probes run
the scripts' sizes: 512 synthetic sections and 200 passes a launch
(``k2_io``), the section layout of RMAT (default scale 22, degree
relabel; :mod:`graph_tpu_torch.probes.k2_layout`), 1,024 sections
(``k2_streams``).
"""

#: Slots of a script's block: 16 tiles of 8 rows x 128 lanes.
TILE = 1024
TPB = 16
BLK = TILE * TPB
#: The scripts' block count (4,194,304 slots), and K1's slot count at
#: RMAT scale 22 in blocks (67,108,864 slots).
NBLK = 256
K1_NBLK = 4096
