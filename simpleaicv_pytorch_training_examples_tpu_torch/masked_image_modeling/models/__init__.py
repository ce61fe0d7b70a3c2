from .vit_mae import (vit_base_patch16_224_mae_pretrain_model,
                      vit_large_patch16_224_mae_pretrain_model,
                      vit_huge_patch14_224_mae_pretrain_model)
