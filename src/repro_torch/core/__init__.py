"""IEMAS core: cache-aware prediction, the column auction, hubs and the
Algorithm-1 router (`repro_torch.core.mechanism.IEMASRouter`)."""
