"""Failure handling (the slice of ``spartan_tpu/resilience`` the port
carries): the error classifier and the checkpointed ``st.loop``."""
