"""The LM substrate's training path, the counterpart of ``repro.train``:
AdamW with clipping and int8 gradient compression (``optimizer``),
checkpoints in repro's on-disk format with atomic publish and resume
(``checkpoint``), repro's sharding rules with their placement on a slot
mesh (``sharding``), and the train step with remat and microbatches plus
the fault-tolerant loop (``train_loop``)."""
