"""Models: the multi-scale facet-graph U-Net, losses, augmentation."""

from facet_graph_convolution_torch.models.unet import (  # noqa: F401
    init_unet,
    unet_apply,
)
from facet_graph_convolution_torch.models.losses import (  # noqa: F401
    face_normals_loss,
    charbonnier_face_normals_loss,
    accuracy_loss,
    full_chamfer_loss,
    sampled_accuracy_loss,
)
from facet_graph_convolution_torch.models.augment import (  # noqa: F401
    random_rotation,
    rotate_inputs,
    rotate_vec3,
)
