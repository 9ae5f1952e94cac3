"""The benchmark harness of ``distributed_tensorflow_framework_torch``.

``run.py`` is the command; this package holds what every cell shares:
finding the cell's files by name (:mod:`.spec`), the traffic generator
(:mod:`.traffic`), the weights (:mod:`.weights`), the training cell driver
(:mod:`.cell`), the comparison that decides ``correct`` (:mod:`.compare`),
the Kineto reader (:mod:`.kineto`) and the frozen bounds and kernel
classes (:mod:`.bounds`). Importing it imports neither torch nor the
program.
"""
