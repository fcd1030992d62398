"""Measurement and debug entry points of the port, run as modules:

    python -m zksnake_tpu_torch.scripts.bench_sortdma --stages dma,tkernel
    python -m zksnake_tpu_torch.scripts.debug_g2_block addaff
"""
