"""The published NVLink rate of one NVIDIA H100 SXM, the yardstick of the
collectives' shares: NVIDIA's data sheet gives 900 GB/s of NVLink
bandwidth a GPU (fourth-generation NVLink, 18 links), counted in both
directions, so 450 GB/s leave a card at most."""

NVLINK_BYTES_S = 450e9   # per direction, one H100 SXM
