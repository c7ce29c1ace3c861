"""Mean host wait of a window step on its batch, ms: the trainer's own
`Trainer.data_wait_s` (the prefetched datamanager's `next_train`)."""

from harness.readers import mean_ms

read = mean_ms("data_wait_s")
