from adaflo_tpu_torch.mesh.structured import StructuredMesh

__all__ = ["StructuredMesh"]
