"""The LM wing of the port: Hymba (hybrid attention + Mamba) serving."""
