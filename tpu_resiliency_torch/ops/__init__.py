"""Device-side operations of the port and their hand-written CUDA kernels
(``csrc/``): the quorum hang-detection lane (:mod:`.quorum`), the
wedged-device fault (:mod:`.device_spin`) and the model step's fused AdamW
update (:mod:`.adamw`)."""
