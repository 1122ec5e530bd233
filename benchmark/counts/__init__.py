"""The yardstick's arithmetic: the H100's published peaks and each
kernel's operations and bytes as functions of the cell's shapes."""
