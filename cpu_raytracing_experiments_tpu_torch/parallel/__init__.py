"""Multi-device rendering: a ('dp', 'sp') mesh of processes over
``torch.distributed``."""
