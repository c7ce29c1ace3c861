"""The data layer: dataparsers, the supervision dataset, the full-image
datamanager and its prefetcher, and the synthetic tabletop generator
(counterpart of the JAX package's data/). Host work is numpy; batches
leave the datamanager as torch tensors on the training device."""
