"""Training pieces of the port. So far only the forward adapters of
``step.py``, in eval mode, which the ``auto`` inference strategy uses."""
