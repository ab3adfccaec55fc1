"""Multi-device solves: one process (rank) per device over
torch.distributed, NCCL between GPUs and gloo where ranks share a device
(the CPU, or several ranks on one card)."""
