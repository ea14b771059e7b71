"""On-card measurement probes: the TPU micro-benchmarks of ``scripts/``
asked again of Hopper kernels.

Each module builds its script's input from the script's seed, launches a
hand-written kernel (:mod:`graph_tpu_torch.probes.kernels`), holds it
against its plain version and prints the script's lines (ms, ns/slot,
exactness).  They run on the card unless given ``--device cpu``:

    python -m graph_tpu_torch.probes.k1_lanemap    # depth probe, lanemap
    python -m graph_tpu_torch.probes.k1_rowmatch [win ...]
    python -m graph_tpu_torch.probes.k1_sublane [win ...]

Sizes follow the scripts: blocks of 16,384 slots (128 rows of 128 lanes),
256 of them by default (``--blocks``).
"""

#: Slots of a script's block: 16 tiles of 8 rows x 128 lanes.
TILE = 1024
TPB = 16
BLK = TILE * TPB
#: The scripts' block count (4,194,304 slots), and K1's slot count at
#: RMAT scale 22 in blocks (67,108,864 slots).
NBLK = 256
K1_NBLK = 4096
