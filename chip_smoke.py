"""Smoke run of the PyTorch / CUDA port (swindet_tpu_torch) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero
before the last line:

1. device  -- requires CUDA; prints the card's name and power limit as
              nvidia-smi reports them, torch's CUDA and the nvcc version.
2. build   -- builds every kernel from swindet_tpu_torch/csrc with nvcc;
              the conv and fused-MLP libraries' SASS must hold
              tensor-core (HGMMA) and TMA (UTMALDG) instructions, the
              v3 and v4 window attentions' HMMA, and so must each of the
              four instances of the tensor-core forward over head-major
              q, k, v (row 14) and over the qkv map (row 15); their bf16
              kernels' and the LayerNorm
              kernels' registers, shared and local memory are printed,
              each instance by its template arguments (the attention
              forward's with the P store on and off and its staging
              policy, the LayerNorm's dtype and chunks a lane).
3. kernels -- holds each of the fifteen kernels against its plain
              PyTorch version on the card at the shapes of the main paths,
              in bf16 and fp32 (NMS: fp32 boxes, exact equality), times
              both with CUDA events, times the one PyTorch call that
              computes the same function where there is one (library_ms;
              for the fused MLP and the v4 attention the unfused chain --
              F.linear -> F.gelu -> F.linear, F.linear -> SDPA -> F.linear
              -- and its autograd backward as unfused_ms), and computes
              each kernel's bound from the bytes and operations of its
              inputs. LayerNorm runs at the seven shapes of a request's
              32 norms, each with its kernel's profiler device ms, and
              at Swin-B's seven (the cascade's 56 norms), and
              its first kernel (a warp a row, for other widths and bases
              off 16 bytes) at the first of them, on a copy of x one
              element past a 16-byte boundary, which the profiler must
              show ran that kernel alone. The
              v1 and full-map attention kernels, which no model path
              runs (as in the JAX package), run only here, each in bf16
              on its tensor-core kernel and in fp32 on its SIMT one (a
              launch of the other fails the run): the v1 one at stage 1,
              its kernel's device ms read apart from its wrapper's
              head-major copy; the full-map one on the padded map of one
              image at every Swin stage with shift 3 and at stage 1 with
              no shift, with its kernel's device ms, the unfused chain
              (roll, partition, SDPA, reverse) and the port's blockwise
              path (gather, row 2, inverse gather) beside it.
              The 3x3 conv and its filter gradient run in bf16 (their
              tensor-core kernels) at every conv shape of the main path
              and in fp32 (their SIMT kernels) at two: FPN P2 and the
              mask head. The window attention's three kernels run in
              bf16 (tensor cores) at every Swin stage's shape, the
              inference forward at a request's windows, the training
              forward and the backward at a training batch's, and in
              fp32 (SIMT) at stages 1 and 4, for Swin-T and again for
              Swin-B (C 128-1,024, 4-32 heads). NMS runs at its four
              shapes (the C4 RPN's N 12,000, keep 2,000 among them) with
              the device time of its mask and scan kernels
              apart (torch.profiler) and the number of 64-box blocks the
              scan visited. The v4 attention (rows 12 and 13) runs in
              bf16 (its tensor-core kernels) at every Swin stage's shape,
              the forward at a request's windows and the backward at a
              training batch's, and in fp32 (SIMT) at stages 1 and 4; its
              bf16 backward is held to the plain version with the
              kernels' bf16 roundings, dx at TOL_SUM and the fp32
              gradients at limits derived on the check's inputs, which a
              control with a 64-row tile of g zeroed must exceed, and
              each output's distance to the fp32 plain version is logged
              beside the bf16 unfused chain's. The fused MLP runs in
              bf16 (its tensor-core kernels) at the forward's serving
              rows of stages 1-3 and training rows of stage 1 and the
              backward's training rows of stages 1-3, and in fp32
              (SIMT) at stages 1 and 3; its
              bf16 weight gradients are held to a limit derived from the
              plain version's summation-order spread, which a control
              with a 64-row tile of g zeroed must exceed. RoIAlign runs
              at serving's and training's bbox and mask shapes, its
              backward at training's, each with its bound; both then at
              7x7 and 14x14 on 256 rois piled on one 20x20-cell area of
              P2 and on edge-case rois (slivers, one past every border,
              reversed, degenerate, invalid); the backward must repeat
              bit for bit.
4. main    -- serving: Mask R-CNN Swin-T (full width, seeded weights,
              bf16, RPN nms_pre = max_per_img = 1000) through
              init_detector and inference_detector on 3 synthetic
              800x1333 images after one warm-up; every inference kernel's
              launch count must rise (NMS twice a request: RPN and
              multiclass) and no training kernel may launch; every conv,
              v3 attention (and fused-MLP) launch must be a tensor-core
              one (``tc_launches``).
5. check   -- the same detector at fp32 on a small canvas, on the card
              (kernels) and on the CPU (plain versions), must agree; its
              convs, attentions (and fused MLPs) run the SIMT kernels,
              no tensor-core one.
6. train   -- training: the same detector in bf16 with the config's
              train_cfg, drop_path_rate 0.1, AdamW with the Swin
              paramwise_cfg and the schedule_1x warm-up, through
              make_train_step on a batch of 2 synthetic 800x1333 images
              (canvas 800x1344) whose painted rectangles are the ground
              truth: 1 warm-up step, 5 timed steps, one step whose NMS
              runs under torch.cuda.set_sync_debug_mode('error') (it
              reads nothing on the host), one validation pass
              (simple_test) of the trained model on the batch, then 2
              profiled steps. Over the timed steps every kernel of the
              configuration but the inference attention kernel must
              launch (NMS once a step), and that one must not, and every
              conv, filter-gradient, attention training-forward and
              attention-backward launch must be a tensor-core one;
              the validation pass, counted on its own, must launch the
              inference kernels and no training kernel.
7. train-check -- forward_train and its gradients in fp32 on a 224x320
              canvas, on the card and on the CPU, with the same weights,
              batch and sampler keys and CHECK_ROIS (128) rois an image,
              must agree (the fp32 run launches
              no tensor-core kernel); a bf16 control run on the card is
              held to the same CPU run and logged.
8. fused   -- phases 4 to 7 again in the fused-MLP configuration, the JAX
              package's switch SWINDET_FUSED_MLP=1: the token MLPs of
              stages 1-3 (10 blocks) run the fused kernels, stage 4 stays
              unfused. Serving launches the fused forward 10 times a
              request; training the forward and the backward 10 times a
              step, every bf16 launch a tensor-core one, every fp32 one
              SIMT. The card-vs-CPU checks hold the same limits.
9. wattn-v4 -- phases 4 to 7 again in the v4 window-attention
              configuration, the JAX package's switch SWINDET_WATTN_V4=1:
              every Swin block's qkv projection, attention and output
              projection run as one kernel. Serving launches the v4
              forward 12 times a request, training the forward and the
              backward 12 times a step, every bf16 launch a tensor-core
              one, every fp32 one SIMT, and none of the v3 attention
              kernels runs. The card-vs-CPU checks hold the same limits.
10. loop  -- training from files through the port's train_detector: a
              synthetic COCO-style dataset of 8 PNG images (4 landscape,
              4 portrait, 480-1600 px, 3-8 painted polygons each, one
              concave), Mask R-CNN Swin-T from the flagship config in
              bf16 with its own train pipeline (flip, both AutoAugment
              branches), 2 images a batch on 2 loader threads: 1 epoch
              (4 iterations), then a second resumed from epoch_1.pth.
              Every logged value must be finite and every gradient
              norm under 1e4, epoch_1.pth and latest.pth must exist, the resumed run must log epoch 2
              alone, every training kernel of the default configuration
              must launch in the first epoch (rows 1 and 3-9; row 2, the
              inference forward, must not), every bf16 conv and attention
              launch must be a tensor-core one, and both the landscape
              (800x1344) and the portrait (1344x800) canvases must run.
              Prints the canvases, each iteration's data_time and
              step_time with their medians, the loader's own time for
              one batch, one batch's host-to-device copy (CUDA events)
              with its gt_masks bytes, and peak device memory. Then
              phase 7's fp32 check once more, default configuration, on
              one batch of the loader at a 320x224 (H x W) portrait
              canvas whose two samples have different pad shapes, the
              card reading the CPU's RPN outputs; apart and unpinned,
              the card's RPN outputs against the CPU's, its proposal
              step on them against the plain step, and its proposals
              against the CPU's as sets. The resumed epoch runs the eval
              hook (validate=True, bbox and segm, save_best 'auto') on
              the same PNGs in test mode: its log must hold one finite
              'mode: val' line and best_bbox_mAP_epoch_2.pth must exist.
11. eval  -- evaluation and test tools. COCOeval and the g++ host
              library on this machine: phase 10's PNG dataset with its
              own ground truth as detections reads 1 for every AP and
              AR in bbox and segm (AR at 1 detection what an image's
              duplicate categories allow), the half-correct case of
              tests/test_data/test_coco_dataset.py 0.5, and the
              library's paste, RLE and IoU equal their numpy versions.
              Then the flagship in bf16 (seeded weights from a .pth)
              through swindet_tpu_torch.tools.test's main on the 8 PNGs
              as data.test, 2 images a batch, --eval bbox segm,
              score_thr 0: after a warm-up run, img/s, 100 detections
              an image and the host split (pipeline and decode, device,
              paste, RLE encode, COCOeval); rows 1-5 launch (NMS twice
              a batch), no training kernel, every conv and attention
              launch a tensor-core one. The same with test-time
              augmentation, flip and the scales (1333, 800) and (1333,
              640): 4 augmentations, NMS 6 times a batch (4 RPN, the
              merged proposals, the final one). Last, fp32 with phase
              5's spread heads on 2 PNGs (a landscape and a portrait) at
              test scale (320, 224) and
              with augmentation (flip, (320, 224) and (320, 192)): the
              card (kernels, no tensor-core launch) against the CPU
              (plain versions), labels equal, boxes within 1e-2 px,
              masks equal off the pixels whose CPU probability lies
              within 1e-3 of the threshold, metrics within 1e-4; a bf16
              control must exceed the box limit.
12. cascade -- Cascade Mask R-CNN Swin-B from its config
              (configs/swin/cascade_mask_rcnn_swin_base_*_giou_4conv1f_*):
              bf16 serving, a warm-up and 3 requests at 800x1333 through
              init_detector and inference_detector, every kernel's
              launches equal to what cascade_launches derives from the
              built model (a request: LayerNorm 56, attention 24, conv3x3
              21, RoIAlign 4, NMS 2; the bbox heads' normed convs run
              F.conv2d); phase 5's fp32 card-vs-CPU check on it with all
              three fc_cls spread and a bf16 control that must fail it,
              at two blocks a stage (CASCADE_CHECK_OPTS);
              1 + 5 make_train_step steps at batch 2 on 800x1344 (a step:
              LayerNorm 56, attention forward-with-P and backward 24
              each, conv3x3 42, its filter gradient 21, RoIAlign forward
              and backward 6 each, NMS 1), the BN running statistics
              moved by a step and left by a validation pass, 2 profiled
              steps; phase 7's fp32 check with pinned proposals, its
              sampler keys per stage, gradients of CASCADE_TRAIN_GRADS,
              at two blocks a stage and 128 rois a stage an image
              (CASCADE_TRAIN_CHECK_OPTS);
              then train_detector for 2 iterations on 4 of phase 10's
              PNGs with the config's own train pipeline, and tools.test
              with the trained checkpoint on 2 of them, plain and with
              test-time augmentation, --eval bbox segm, score_thr 0 (100
              detections an image).
13. reppoints -- RepPoints-moment Swin-T from its config
              (configs/reppoints/reppoints_moment_swin_tiny_*, bf16 set
              on top, as the Swin configs compute): serving, the
              class output's bias shifted so that 4,096 (point, class)
              pairs of the warm-up request clear score_thr (the bias is
              logged; seeded weights score every pair at the 0.01 prior),
              a warm-up and 3 requests at 800x1333 through init_detector
              and inference_detector, 100 detections each, every kernel's
              launches equal to what reppoints_launches derives (a
              request: LayerNorm 32, attention 12, conv3x3 33 -- the FPN's
              3 output convs and 6 stacked head convs on 5 levels; the
              FPN's stride-2 extra convs and the initial points' 3x3 conv
              run F.conv2d --, NMS 1); phase 5's fp32 card-vs-CPU check
              on it with reppoints_cls_out's weight spread, detections and
              candidate scores held, a bf16 control that must fail it;
              1 + 5 make_train_step steps at batch 2 on 800x1344 without
              gt_masks (a step: LayerNorm 32, attention forward-with-P and
              backward 12 each, conv3x3 66, its filter gradient 33), 2
              profiled steps and the deformable convs' device ms (each
              call of a step replayed on its own inputs, forward and
              backward apart); phase 7's fp32 check of its three losses
              and the gradients of REPPOINTS_TRAIN_GRADS with a bf16
              control, the refined stage's assignment pinned to the CPU's
              where noise at an IoU boundary moves it; then
              train_detector for 2 iterations on 2 of phase 10's PNGs with
              the config's own bbox-only pipeline (no gt_masks in a
              batch), and tools.test with the trained checkpoint on them,
              plain and with test-time augmentation (flip and two scales,
              aug_test_single_stage: one NMS a batch), --eval bbox,
              score_thr 0.
14. resnet -- Faster R-CNN R-50 and RetinaNet R-50 from their configs
              (configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py,
              configs/retinanet/retinanet_r50_fpn_1x_coco.py, bf16 set on
              top; ResNet-50 with frozen BN and frozen_stages=1, SGD),
              each: serving, a warm-up and 3 requests at 800x1333 (for
              RetinaNet the class output's bias shifted so that 4,096
              (anchor, class) pairs of the warm-up request clear
              score_thr, 100 detections each), every kernel's launches
              equal to what resnet_launches derives (a request: Faster
              R-CNN conv3x3 9 -- the FPN's 4 output convs and the RPN
              conv on 5 levels --, RoIAlign 1, NMS 2; RetinaNet conv3x3
              43 -- the FPN's 3 output convs and 8 tower convs on 5
              levels --, NMS 1; the ResNet's convs run F.conv2d); phase
              5's fp32 card-vs-CPU check with a bf16 control that must
              fail it; 1 + 5 make_train_step steps at batch 2 on
              800x1344 without gt_masks (a step: Faster R-CNN conv3x3 18,
              its filter gradient 9, RoIAlign forward and backward 1
              each, NMS 1; RetinaNet conv3x3 86, its filter gradient 43),
              the frozen BN buffers unmoved, the frozen stages' zero
              gradients, 2 profiled steps with the kernel ms split into
              the hand-written kernels and the library's convolutions
              and GEMMs; phase 7's fp32 check with a bf16 control
              (Faster R-CNN's proposals pinned, its chain checked
              apart); then, Faster
              R-CNN only, train_detector for one epoch (one iteration) on
              2 of phase 10's PNGs with the config's bbox-only pipeline
              and a second epoch resumed from epoch_1.pth, and for both
              tools.test on the 2 PNGs (Faster R-CNN's trained
              checkpoint, RetinaNet's seeded one), --eval bbox, score_thr
              0 (100 detections an image).
15. zoo    -- the ResNet zoo's variants from their configs, bf16 set on
              top: Mask R-CNN R-50 with DCNv2 in stages 2-4 (mdconv),
              Faster R-CNN R-50 with DCN (dconv), Mask R-CNN R-50 with GN
              and ConvWS (gn_ws), Mask R-CNN R-50 C4 (c4), Faster R-CNN
              R-50 DC5 (dc5), Faster R-CNN R-50 with modulated deformable
              RoI pooling (mdpool) and Cascade R-CNN R-50 (cascade_r50),
              each: a warm-up and 2 requests at 800x1333, every launch
              equal to what zoo_launches derives, and phase 14's fp32
              serving check with its bf16 control; mdconv, gn_ws, c4 and
              mdpool also 1 + 3 make_train_step steps at batch 2 on
              800x1344 (launches checked, frozen BN buffers unmoved, a
              profiled step, the plain deformable ops' ms) and phase 7's
              fp32 training check, proposals pinned, 128 rois an image
              (CHECK_ROI_CUT; phase 16's too, gn_ws's not); mdconv also
              train_detector and tools.test from files. Phase 3 holds
              rows 3, 8, 4 and 9 at these configs' new widths too: the
              conv and its filter gradient at 1x50x84 and 2x50x84 with
              1024 and 2048 channels, RoIAlign and its backward on one
              stride-16 level at 14x14x1024 and 7x7x2048 (1,000 rois
              serving, 512 training).
16. backbones -- phase 15's steps over the ResNet plugins and the
              ResNet-family backbones: Mask R-CNN R-50 with ContextBlocks
              (gcb), Faster R-CNN R-50 with GeneralizedAttention '1111'
              (attn), Faster R-CNN RegNetX-3.2GF (regnet), Res2Net-101
              (res2net) and ResNeSt-50 (resnest), Mask R-CNN HRNetV2p-W32
              with HRFPN (hrnet): each serving and its fp32 serving check;
              gcb, attn, resnest and hrnet training (the plugins' ms a
              step) and their fp32 training checks, a plugin parameter
              among the checked gradients, the plugins' zero-init
              parameters drawn on both sides; hrnet also train_detector
              and tools.test from files. These run the kernels phase 15
              runs at the main path's 256-channel shapes; HRFPN's convs
              are F.conv2d.
17. dense -- RPN-only and Fast R-CNN, FCOS and NAS-FCOS from their
              configs, bf16 set on top: the FPN RPN (rpn), the C4 RPN
              (rpn_c4: one stride-16 map, 15 anchors, its RPN conv at
              1,024 channels, NMS of 12,000 candidates keeping 2,000),
              Fast R-CNN R-50 (fast_rcnn), FCOS R-50 (fcos: 8 norm-free
              tower convs on 5 levels, 40 conv3x3 launches a request),
              FCOS with GN towers, centre sampling, norm_on_bbox and GIoU
              (fcos_gn) and NAS-FCOS (nasfcos: the searched neck and head,
              DCNv2 cells and towers); each: a warm-up and 2 requests at
              800x1333 through init_detector and inference_detector (Fast
              R-CNN through preprocess_images and its simple_test on the
              FPN RPN's proposals of the same image; an FCOS head's class
              bias shifted first so that 4,096 pairs clear score_thr), ms
              a request and peak memory, every launch equal to what
              dense_launches derives; phase 14's fp32 serving check with
              its bf16 control (an RPN's proposals matched as sets both
              ways); all but the C4 RPN 1 + 3 training steps at batch 2 on
              800x1344 (make_train_step; Fast R-CNN a step written here on
              the FPN RPN's proposals padded to 2,000 slots), launches
              checked, BN buffers unmoved, a profiled step, NAS-FCOS's
              deformable convs' ms; the RPN's and FCOS's fp32 training
              checks with bf16 controls; the FPN RPN through
              train_detector and tools.test --eval proposal from files
              (AR@100/300/1000).
18. atss  -- the ATSS line from its configs, bf16 set on top: ATSS R-50
              (atss), GFL R-50 (gfl) and VFNet R-50 (vfnet: its plain
              deformable star convs); each as a phase-17 FCOS config: a
              warm-up and 2 requests at 800x1333 (the class bias shifted
              so that 4,096 pairs clear score_thr), its fp32 serving
              check with a bf16 control (ATSS' centerness zeroed), 1 + 3
              training steps at batch 2 on 800x1344, launches checked,
              BN buffers unmoved, a profiled step, VFNet's deformable
              convs' ms; GFL's and VFNet's fp32 training checks with bf16
              controls. Their GN towers run F.conv2d: the FPN's output
              convs, the NMS and in training the filter gradients launch
              the kernels.
19. paa-ld -- PAA R-50 (paa) and LD (ld: a ResNet-18 GFL student of a
              GFL R-50 teacher) from their configs, bf16 set on top, each
              as a phase-18 config: a warm-up and 2 requests, the fp32
              serving check with a bf16 control (PAA's IoU branch zeroed,
              at its sqrt score's threshold), 1 + 3 training steps with
              PAA's EM ms and host reads a step and LD's teacher held
              bit-equal in eval mode; PAA's fp32 training check in two
              parts (the CPU's float64 EM on the card's candidate losses
              selects what the card's selected; the step with the
              assignment pinned to the card's keep mask), LD's as GFL's,
              loss_ld among the losses; both with bf16 controls. The
              FPN's output convs (LD's teacher's too, forward only, in
              training), the NMS and the filter gradients launch the
              kernels.
20. htc   -- Hybrid Task Cascade R-50 from its configs, bf16 set on top:
              first rows 4 and 9 against their plain versions at the
              semantic branch's shapes (one stride-8 level of
              100x168x256, 14x14 bins: a stage's 2 x 512 training rois
              forward and backward, serving's 1,000 proposals and 100
              detections), bf16 and fp32; then htc (with the fused
              semantic branch): a warm-up and 2 requests at 800x1333, ms
              a request and peak memory, every launch equal to what
              htc_launches derives (a request: conv3x3 25 -- the FPN's
              4, the RPN conv on 5 levels, the semantic tower's 4, each
              stage's mask head's 4 --, RoIAlign 8 -- 3 bbox stages and
              the mask branch, each also on the semantic embedding --,
              NMS 2); phase 12's fp32 serving check with a bf16 control;
              1 + 3 make_train_step steps at batch 2 on 800x1344 with a
              1/8-scale stuff map an image (a step: conv3x3 74 and its
              filter gradient 37 -- the mask flow runs heads 0..i at
              stage i, 24 mask-head conv passes --, RoIAlign forward and
              backward 12 each, NMS 1), frozen BN buffers unmoved, a
              profiled step; phase 7's fp32 training check with the
              semantic loss's gradients as their own group, sampler keys
              by call order (the interleaved mask sample after each
              stage's bbox sample), 128 rois a stage an image, proposals
              pinned, with a bf16 control; train_detector and tools.test
              --eval bbox segm from PNG images and grayscale stuff-map
              PNGs written here (LoadAnnotations with_seg, SegRescale);
              then htc_without_semantic serving and its fp32 serving
              check.
21. roi   -- the RoI-head variants from their configs, bf16 set on top:
              first rows 4 and 9 against their plain versions at GRoIE's
              shapes (every roi pooled on every level; on the finest,
              200x336x256: a step's 2 x 512 rois at 7x7 and 512 at 14x14,
              forward and backward, serving's 1,000 proposals and 100
              detections), bf16 and fp32; then Mask Scoring R-CNN
              (ms_rcnn), GRoIE Mask R-CNN (groie), Double-Head Faster
              R-CNN (dh) and Dynamic R-CNN (dynamic), all R-50 FPN, each:
              a warm-up and 2 requests at 800x1333, ms a request and peak
              memory, every launch equal to what roi_launches derives (a
              request: conv3x3 17 / 13 / 9 / 9, RoIAlign 3 / 8 / 2 / 1 --
              ms_rcnn's mask branch runs twice, GRoIE pools once a level,
              the Double-Head's rois twice --, NMS 2); phase 12's fp32
              serving check with a bf16 control (mask scores held with
              the masks, GRoIE's attention drawn); 1 + 3 make_train_step
              steps at batch 2 on 800x1344, the frozen BN buffers
              unmoved, the Double-Head's BN statistics moved, Dynamic
              R-CNN's values advanced once a step, a profiled step and
              GRoIE's attention's ms; phase 7's fp32 training check with
              CHECK_ROIS rois an image, proposals pinned, the MaskIoU
              loss's gradients as their own group, with a bf16 control.

Each phase's wall time is logged under [time].

Then one JSON line of per-kernel results (``launches``: the serving
and the training runs' counts of the three configurations, phase 11's
test and TTA runs, phase 12's cascade serving and training and phase
13's RepPoints serving and training and phase 14's Faster R-CNN and
RetinaNet serving and training, each from its own reset, summed;
each also apart, phase 11's as ``eval_launches`` and ``tta_launches``,
phase 12's as ``cascade_serve_launches`` and ``cascade_train_launches``,
phase 13's as ``reppoints_serve_launches`` and
``reppoints_train_launches``, phase 14's as ``faster_serve_launches``,
``faster_train_launches``, ``retina_serve_launches`` and
``retina_train_launches``, phase 15's and 16's as
``<config>_serve_launches`` and, for the four of each that train,
``<config>_train_launches``, phase 17's as ``dense_<config>_serve_launches``
and ``dense_<config>_train_launches``, phase 18's as
``atss_<config>_serve_launches`` and ``atss_<config>_train_launches``,
phase 19's as ``paa_ld_<config>_serve_launches`` and
``paa_ld_<config>_train_launches``, phase 20's as
``htc_<config>_serve_launches`` and ``htc_htc_train_launches``, phase
21's as ``roi_<config>_serve_launches`` and
``roi_<config>_train_launches``; for
the conv,
fused-MLP and v1, v3,
v4 and full-map attention rows also ``tc_launches``, counted the same
way; ``shapes``, the bf16 readings at every main-path shape, for those,
LayerNorm, RoIAlign and its backward and NMS; ``swin_b_shapes``, the
readings at Swin-B's shapes, for LayerNorm and rows 2, 6 and 7;
``device_ms`` for
LayerNorm and the v1 and full-map attentions, for the v1 one
``copy_device_ms``, for the full-map one ``unfused_ms``,
``unfused_device_ms``, ``blockwise_ms`` and ``blockwise_device_ms``, and
for LayerNorm ``first_kernel``, its first kernel's reading), the card's
name and power limit,
and, last, one JSON line with the device. It imports neither jax nor the
JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from swindet_tpu_torch import inference_detector, init_detector
from swindet_tpu_torch.apis import format_results, train_detector
from swindet_tpu_torch.apis.test import eval_batches
from swindet_tpu_torch.checkpoint import save_checkpoint
from swindet_tpu_torch.core import host_ops, rle
from swindet_tpu_torch.core import masks as mask_ops
from swindet_tpu_torch.core.class_names import COCO_CLASSES
from swindet_tpu_torch.datasets import (build_dataloader, build_dataset,
                                        derive_canvas)
from swindet_tpu_torch.datasets.api import COCO, COCOeval
from swindet_tpu_torch.engine import (build_lr_schedule, build_optimizer,
                                      make_train_step)
from swindet_tpu_torch.ops import (FUSED_MLP_KERNELS, INFERENCE_KERNELS,
                                   KERNEL_WRAPPERS, OP_ONLY_KERNELS,
                                   TENSOR_CORE_KERNELS, TRAINING_KERNELS,
                                   WATTN_V4_KERNELS, build,
                                   conv3x3, conv3x3_dw, conv3x3_dw_reference,
                                   conv3x3_reference, fused_mlp,
                                   fused_mlp_bwd, fused_mlp_bwd_limits,
                                   fused_mlp_bwd_reference,
                                   fused_mlp_reference, launch_counts,
                                   layer_norm, layer_norm_reference,
                                   multilevel_roi_align,
                                   multilevel_roi_align_backward,
                                   nms_sorted, nms_sorted_reference,
                                   reset_launch_counts, roi_align,
                                   tc_launch_counts,
                                   roi_align_bwd, swin_attention_reference,
                                   swin_window_attention, window_attention,
                                   window_attention_bwd,
                                   window_attention_bwd_reference,
                                   window_attention_fwd_p,
                                   window_attention_fwd_p_reference,
                                   window_attention_reference,
                                   window_attention_v3, window_attention_v4,
                                   window_attention_v4_bwd,
                                   window_attention_v4_bwd_limits,
                                   window_attention_v4_bwd_reference,
                                   window_attention_v4_reference)
from swindet_tpu_torch.ops.roi_align import _flat_layout, _taps, map_roi_levels
from swindet_tpu_torch.models import build_detector
from swindet_tpu_torch.models.backbones.swin import (WindowAttention,
                                                     shifted_window_attn_mask,
                                                     window_gather_indices)
from swindet_tpu_torch.models.dense_heads import rpn_head as rpn_head_module
from swindet_tpu_torch.tools import test as test_cli
from swindet_tpu_torch.utils import Config

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(
    REPO, 'configs/swin/'
    'mask_rcnn_swin_tiny_patch4_window7_mstrain_480-800_adamw_1x_coco.py')

KERNELS = {
    'layer_norm': dict(
        source='swindet_tpu_torch/csrc/layer_norm.cu',
        replaces='swindet_tpu/ops/layer_norm.py:22'),
    'window_attention_v3': dict(
        source='swindet_tpu_torch/csrc/window_attention.cu',
        replaces='swindet_tpu/ops/window_attention_v3.py:38'),
    'conv3x3': dict(
        source='swindet_tpu_torch/csrc/conv3x3.cu',
        replaces='swindet_tpu/ops/conv3x3.py:25'),
    'roi_align': dict(
        source='swindet_tpu_torch/csrc/roi_align.cu',
        replaces='swindet_tpu/ops/roi_align_pallas.py:92'),
    'window_attention_fwd_p': dict(
        source='swindet_tpu_torch/csrc/window_attention.cu',
        replaces='swindet_tpu/ops/window_attention_v3.py:209'),
    'window_attention_bwd': dict(
        source='swindet_tpu_torch/csrc/window_attention.cu',
        replaces='swindet_tpu/ops/window_attention_v3.py:119'),
    'conv3x3_dw': dict(
        source='swindet_tpu_torch/csrc/conv3x3.cu',
        replaces='swindet_tpu/ops/conv3x3.py:112'),
    'roi_align_bwd': dict(
        source='swindet_tpu_torch/csrc/roi_align.cu',
        replaces='swindet_tpu/ops/roi_align_pallas.py:411'),
    'nms_sorted': dict(
        source='swindet_tpu_torch/csrc/nms.cu',
        replaces='swindet_tpu/ops/nms_pallas.py:38'),
    'fused_mlp': dict(
        source='swindet_tpu_torch/csrc/fused_mlp.cu',
        replaces='swindet_tpu/ops/fused_mlp.py:78'),
    'fused_mlp_bwd': dict(
        source='swindet_tpu_torch/csrc/fused_mlp.cu',
        replaces='swindet_tpu/ops/fused_mlp.py:115'),
    'window_attention_v4': dict(
        source='swindet_tpu_torch/csrc/window_attention_v4.cu',
        replaces='swindet_tpu/ops/window_attention_v4.py:74'),
    'window_attention_v4_bwd': dict(
        source='swindet_tpu_torch/csrc/window_attention_v4.cu',
        replaces='swindet_tpu/ops/window_attention_v4.py:141'),
    'window_attention': dict(
        source='swindet_tpu_torch/csrc/window_attention.cu',
        replaces='swindet_tpu/ops/window_attention.py:30'),
    'swin_window_attention': dict(
        source='swindet_tpu_torch/csrc/window_attention.cu',
        replaces='swindet_tpu/ops/swin_attention.py:46'),
}
# |kernel - plain| <= ATOL + RTOL * |plain|: fp32 differs by summation
# order only; bf16 outputs are each rounded once from fp32 on both sides,
# so they may differ by about one bf16 unit (2^-8 relative) of the output
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# RoIAlign in fp32: the plain version's elementwise ops and the kernel may
# round a sample coordinate one ulp apart (measured on the H100: up to
# 1.8e-4 on level-0 rois at x ~ 290 cells, where one ulp is 3e-5 cells
# and N(0, 1) feature maps change by up to ~6 per cell)
TOL_ROI_FP32 = (1e-3, 1e-4)
# The backward kernels sum over windows, pixels or rois across blocks, by
# fp32 atomics in an order that changes from run to run (RoIAlign's sums
# its rois in index order instead, and must repeat bit for bit), and their
# entries cancel (a sum of ~1e5 signed products can be near zero while
# each product is not): |kernel - plain| <= TOL_SUM * max|plain| per
# output, a little looser than the forwards' elementwise tolerance. bf16
# outputs add one bf16 rounding (2^-8); RoIAlign's fp32 adds the one-ulp
# sample coordinates above.
TOL_SUM = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TOL_SUM_ROI_FP32 = 1e-3
# The fused MLP forward is held elementwise to TOL: its fp32 sums run in
# another order than the plain version's matmuls, its erf may contract
# into fused multiply-adds (a few fp32 ulps), and in bf16 a rounding of
# the hidden activation may land one bf16 unit apart. Its backward sums
# over rows (the weight gradients by fp32 atomics, in a changing order)
# from terms rounded to bf16 in a bf16 run, so it is held per output to
# TOL_SUM of the largest entry, but for the fp32 weight gradients of a
# bf16 run (dw1, db1, dw2): a and dh are rounded to bf16 from fp32 sums
# whose order decides the rounding, which moves them by more than TOL_SUM
# allows, so each is held to the largest of TOL_SUM[fp32] of its largest
# entry, ORDER_SPREAD_FACTOR (4) times the plain version's own spread
# under another summation order and the change one rounding flip can
# make, on the inputs of the check (_mlp_bwd_limits, with a control that
# must exceed it). NMS must equal its plain version exactly (count,
# indices and detections): its IoU rounds as the plain version's.
# The v4 attention forward is held elementwise to TOL against its plain
# version computed in fp32 on the same inputs and rounded once to the
# compute dtype: the SIMT kernel (fp32) keeps qkv, P and the attention
# output in fp32, the tensor-core kernel (bf16) rounds them to bf16 as
# the JAX package's bf16 chain does (max |d| 0.0078-0.0156 against TOL's
# 2e-2 + 2e-2 |out|). Its fp32 backward is held to TOL_SUM against the
# fp32 plain version. The bf16 backward's tensor-core kernels round
# their operands to bf16 (q, k, v, P, the attention output, d(attn), dS,
# dqkv, the weights), which moves the fp32 weight gradients by 2e-3 to
# 8e-3 of their largest entry, as much as the bf16 autograd of the
# unfused chain: it is held to the plain version with the same roundings
# (tc_rounding), dx at TOL_SUM[bf16] and the fp32 outputs at limits
# derived as the fused MLP's (_v4_bwd_check).
FPN_SHAPES = ((200, 336), (100, 168), (50, 84), (25, 42))
# the Swin stages of an 800x1344 canvas: windows of one image, C, heads
# and the map padded to whole 7x7 windows (the shift mask's (Hp, Wp))
ATTN_STAGES = ((1392, 96, 3, (203, 336)), (360, 192, 6, (105, 168)),
               (96, 384, 12, (56, 84)), (24, 768, 24, (28, 42)))
# the (rows, C) of Swin-T's 32 LayerNorms on an 800x1344 canvas, a request's:
# the patch embedding's and stage 1's (6 norms), the first merge norm,
# stage 2's (5), the second merge norm, stage 3's (13), the third merge
# norm, stage 4's (5)
LN_SHAPES = ((67200, 96), (16800, 384), (16800, 192), (4200, 768),
             (4200, 384), (1050, 1536), (1050, 768))
# the same for Swin-B (C 128, heads 4-32), the cascade's backbone: its
# stages' windows, C and heads, and its 56 norms' seven (rows, C)
SWINB_ATTN_STAGES = ((1392, 128, 4, (203, 336)), (360, 256, 8, (105, 168)),
                     (96, 512, 16, (56, 84)), (24, 1024, 32, (28, 42)))
SWINB_LN_SHAPES = ((67200, 128), (16800, 512), (16800, 256), (4200, 1024),
                   (4200, 512), (1050, 2048), (1050, 1024))
# H100 SXM data-sheet rates (dense bf16 tensor cores, fp32 outside the
# tensor cores, HBM3)
PEAK_FLOPS = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# operations of one IoU of the NMS kernel: two areas (2 subtractions, 2
# clamps, 1 product each), the intersection (2 min, 2 max, 2
# subtractions, 2 clamps, 1 product), the union (an addition, a
# subtraction, a clamp), a division and a comparison
NMS_OPS_PER_IOU = 24
IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)
# COCO train2017 (118,287 images) at the config's 16 images per batch,
# for the schedule's epoch boundaries
ITERS_PER_EPOCH = 7393


def log(phase: str, msg: str) -> None:
    print(f'[{phase}] {msg}', flush=True)


def cuda_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Mean device time of fn() in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------- phase 1
# the card's name and power limit as nvidia-smi gives them (phase_device)
CARD = 'not read'


def phase_device() -> str:
    global CARD
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device; the port is measured '
                         'on a GPU only')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    CARD = smi
    print(smi, flush=True)
    nvcc = subprocess.run([build.nvcc_path(), '--version'],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    log('device', f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
                  f'{torch.cuda.device_count()} device(s); nvcc: {nvcc}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ------------------------------------------------------------- phase 2
def _demangle(names):
    """C++ names of mangled kernel symbols, by c++filt where the host has
    it (else the mangled names), template arguments kept and the
    parameter list dropped."""
    try:
        out = subprocess.run(['c++filt'], input='\n'.join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)
    return [re.sub(r'^void |\(.*$', '', n).replace('swindet::', '')
            for n in out]


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = build.build()
    log('build', f'{len(paths)} kernel libraries in '
                 f'{time.perf_counter() - t0:.1f} s: '
                 + ', '.join(p.name for p in paths.values()))
    # the bf16 conv and fused-MLP kernels must be tensor-core (HGMMA)
    # kernels fed by TMA (UTMALDG), the window attentions' (v3 and v4) hold
    # mma.sync (HMMA), every instance of the tensor-core forward over
    # head-major q, k, v (row 14) and over the qkv map (row 15) among them;
    # their registers, shared memory and local memory (spills), and the
    # LayerNorm kernels'
    tool = os.path.join(os.path.dirname(build.nvcc_path()), 'cuobjdump')
    for name, pattern, wanted in (
            ('conv3x3', r'conv3x3\w*_tc_kernel', ('HGMMA', 'UTMALDG')),
            ('fused_mlp', r'mlp\w*_tc_kernel', ('HGMMA', 'UTMALDG')),
            ('window_attention', r'wattn_\w*_tc_kernel', ('HMMA',)),
            ('window_attention_v4', r'wattn4\w*_tc_kernel', ('HMMA',)),
            ('layer_norm', r'layer_norm\w*_kernel', ())):
        lib = str(paths[name])
        if wanted:
            sass = subprocess.run([tool, '-sass', lib], capture_output=True,
                                  text=True, timeout=300, check=True).stdout
            ops = {op: sum(op in line for line in sass.splitlines())
                   for op in wanted}
            log('build', f'{name} SASS: ' + ', '.join(
                f'{v} {op}' for op, v in ops.items()) + ' instructions')
            if not all(ops.values()):
                raise AssertionError(f'{name}: no tensor-core or TMA '
                                     f'instructions in {lib}: {ops}')
        if name == 'window_attention':
            for policy, row in (('HeadMajorTc', 14), ('SwinMapTc', 15)):
                fns = [f for f in sass.split('Function : ')[1:]
                       if policy in f.splitlines()[0]]
                hmma = [f.count('HMMA') for f in fns]
                log('build', f'  the {policy} tensor-core instances (row '
                             f'{row}): {hmma} HMMA instructions')
                if len(hmma) != 4 or not all(hmma):
                    raise AssertionError(f'window_attention: {policy} '
                                         f'tensor-core instances {hmma}')
        usage = subprocess.run([tool, '-res-usage', lib],
                               capture_output=True, text=True, timeout=300,
                               check=True).stdout.splitlines()
        found = [(re.search(r'Function (\S+?):?$', fn.strip())[1],
                  res.strip()) for fn, res in zip(usage, usage[1:])
                 if 'Function' in fn and re.search(pattern, fn)]
        for kernel, (_, res) in zip(_demangle([f for f, _ in found]),
                                    found):
            log('build', f'  {kernel}: {res}')


# ------------------------------------------------------------- phase 3
def _tensors(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes, flops, peak=PEAK_FLOPS):
    """Least time (ms) of the work on the card: its bytes over the memory
    rate or its operations over their peak rate (the bf16 tensor-core rate
    unless given), whichever is larger, and which it was."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _compare(name, dtype, kernel_fn, plain_fn, shape_note, work=None,
             library_fn=None, summed=False, exact=False, limits=None,
             plain_iters=None):
    """Hold kernel_fn() against plain_fn() (each a tensor or a tuple of
    them), time both and, if given, library_fn; ``work`` (bytes, flops[,
    peak]) gives the bound. ``summed`` picks the scale-relative TOL_SUM
    check of the backward kernels, ``exact`` equality; ``limits``, one
    entry per output, replaces an output's summed limit by its entry where
    that is not None. ``plain_iters``: time the plain version over that
    many calls, its call for the comparison the only warm-up (a slow
    one), else as cuda_ms does."""
    got = _tensors(kernel_fn())
    want = _tensors(plain_fn())
    torch.cuda.synchronize()
    max_err = 0.0
    limits = limits or [None] * len(want)
    for g, w, lim in zip(got, want, limits, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f'{name} {dtype}: kernel gives {g.shape} '
                                 f'{g.dtype}, plain {w.shape} {w.dtype}')
        g, w, odt = g.float(), w.float(), g.dtype
        if not torch.isfinite(g).all():
            raise AssertionError(f'{name} {dtype}: non-finite kernel output')
        err = (g - w).abs()
        if exact:
            excess = 0.0 if torch.equal(g, w) else 1.0
            rule = 'equality'
        elif lim is not None:
            excess = err.max().item() - lim
            rule = f'the derived limit {lim:.3g}'
        elif summed:
            tol = TOL_SUM_ROI_FP32 if (
                name, odt) == ('roi_align_bwd', torch.float32) \
                else TOL_SUM[odt]
            limit = tol * w.abs().max().item()
            excess = err.max().item() - limit
            rule = f'{tol} x max|plain| = {limit:.3g}'
        else:
            atol, rtol = TOL_ROI_FP32 if (name, odt) == (
                'roi_align', torch.float32) else TOL[odt]
            excess = (err - (atol + rtol * w.abs())).max().item()
            rule = f'atol {atol} + rtol {rtol}'
        if excess > 0:
            raise AssertionError(f'{name} {dtype} {shape_note}: max |d| = '
                                 f'{err.max().item():.3g} over {rule}')
        max_err = max(max_err, err.max().item())
    ms = cuda_ms(kernel_fn, iters=20)
    plain_ms = cuda_ms(plain_fn) if plain_iters is None else \
        cuda_ms(plain_fn, warmup=0, iters=plain_iters)
    r = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, shape=shape_note,
             library_ms=None if library_fn is None else cuda_ms(library_fn,
                                                                 iters=20))
    if work is not None:
        r['bound_ms'], r['bound_by'] = bound(*work)
    log('kernels', f'{name} {str(dtype)[6:]} {shape_note}: max|d| '
                   f'{max_err:.3g}; kernel {ms:.4f} ms, plain '
                   f'{plain_ms:.4f} ms'
                   + ('' if library_fn is None else
                      f', library {r["library_ms"]:.4f} ms')
                   + ('' if work is None else
                      f', bound {r["bound_ms"]:.4f} ms ({r["bound_by"]})'))
    return r


def _rois(gen, n, img_h=800, img_w=1344, batch=1):
    """Proposal-like rois over an 800x1344 canvas: log-uniform sizes of
    8-800 px, aspect ratios 1/3-3, clipped to the image, spread over
    ``batch`` images."""
    u = torch.rand(n, 5, generator=gen)
    size = 8.0 * 100.0 ** u[:, 0]
    aspect = 3.0 ** (2 * u[:, 1] - 1)
    w, h = size * aspect.sqrt(), size / aspect.sqrt()
    cx, cy = u[:, 2] * img_w, u[:, 3] * img_h
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    boxes[:, 0::2] = boxes[:, 0::2].clamp(0, img_w)
    boxes[:, 1::2] = boxes[:, 1::2].clamp(0, img_h)
    b = (u[:, 4] * batch).floor().clamp(max=batch - 1)
    return torch.cat([b[:, None], boxes], 1).cuda().contiguous()


def _attn_flops(b_, n, c, matmuls):
    """``matmuls`` N x N x hd products per (window, head), 2 flops each."""
    return 2.0 * matmuls * b_ * n * n * c


def _roi_work(shapes, rois, strides, out_size):
    """What the RoIAlign of ``rois`` needs on these inputs: the distinct
    feature rows (of C values) that the bilinear taps of its samples read,
    and the number of samples, both over the samples that lie inside the
    map and belong to the adaptive grid of their bin. ``shapes``: (H, W)
    per level."""
    offsets, total = _flat_layout(shapes)
    lvl = map_roi_levels(rois, len(shapes))
    rows, samples = [], 0
    for s in range(0, rois.shape[0], 64):
        idx, _, valid, wgt = _taps(rois[s:s + 64], lvl[s:s + 64], shapes,
                                   offsets, strides, total, out_size, 0)
        r = wgt.shape[2]
        used = valid & (wgt.expand(-1, out_size, r, out_size, r)
                        .reshape(valid.shape) > 0)
        samples += int(used.sum())
        rows += [i[used].unique() for i in idx]
    return torch.cat(rows).unique().numel(), samples


# rois of ROADMAP section 3 item 3 and the borders on an 800x1344 canvas,
# [batch, x1, y1, x2, y2]: corners, a full-width and a full-height
# sliver, one past every border, one that is reversed, one degenerate
# and one invalid (last)
ROI_EDGE_CASES = (
    (0, 0, 0, 60, 60), (1, 1300, 760, 1344, 800), (1, 0, 400, 1344, 406),
    (0, 600, 0, 612, 800), (1, -400, -240, 1900, 1700),
    (0, 700, 500, 650, 420), (1, 5, 5, 5, 5), (0, 100, 100, 300, 300))


def _crowded_rois(gen, n, x0=400.0, y0=300.0, cells=20, stride=4,
                  device='cuda'):
    """n rois of 8-80 px, all inside one cells x cells area of P2 whose
    corner is (x0, y0) px, spread over a batch of 2."""
    u = torch.rand(n, 4, generator=gen)
    side = cells * stride
    w, h = 8 + u[:, 0] * (side - 8), 8 + u[:, 1] * (side - 8)
    x1, y1 = x0 + u[:, 2] * (side - w), y0 + u[:, 3] * (side - h)
    b = (torch.arange(n) % 2).float()
    return torch.stack([b, x1, y1, x1 + w, y1 + h], 1).to(device) \
        .contiguous()


def roi_checks(dtype, gen, randn):
    """RoIAlign (row 4) and its backward (row 9) against their plain
    versions at the main paths' shapes, each with its bound: the forward
    at serving's bbox (1000 rois 7x7) and mask (100 rois 14x14) shapes,
    batch 1, and at training's (1024 rois 7x7, 256 rois 14x14, batch 2),
    the backward at training's; then both at 7x7 and 14x14 on 256 rois
    piled on one 20x20-cell area of P2 (the backward's tiles each sum many
    overlapping rois) and on the edge-case rois, with one of them invalid.
    The backward must repeat bit for bit (it has no atomics). Returns the
    forward's and the backward's rows, the bbox shape first, with every
    main-path shape in ``shapes``."""
    strides = (4, 8, 16, 32)
    el = torch.finfo(dtype).bits // 8
    fwd, bwd = [], []
    shapes = [(2, h, w, 256) for h, w in FPN_SHAPES]
    level_bytes = sum(np.prod(s) for s in shapes) * el
    feats = {b: [randn(b, h, w, 256).to(dtype) for h, w in FPN_SHAPES]
             for b in (1, 2)}
    for n, size, b in ((1000, 7, 1), (100, 14, 1), (1024, 7, 2),
                       (256, 14, 2)):
        rois = _rois(gen, n, batch=b)
        touched, samples = _roi_work(FPN_SHAPES, rois, strides, size)
        note = f'{n} rois {size}x{size}x256' + ('' if b == 1 else
                                                 f', batch {b}')
        fwd.append(_compare(
            'roi_align', dtype,
            lambda: roi_align(feats[b], rois, strides, size),
            lambda: multilevel_roi_align(feats[b], rois, strides, size),
            note, work=(touched * 256 * el + _nbytes(rois)
                        + n * size * size * 256 * el,
                        samples * 256 * 4 * 2.0), plain_iters=2))
        if b == 1:
            continue
        g = randn(n, size, size, 256).to(dtype)
        bwd.append(_compare(
            'roi_align_bwd', dtype,
            lambda: roi_align_bwd(shapes, dtype, rois, g, strides, size),
            lambda: multilevel_roi_align_backward(shapes, dtype, rois, g,
                                                  strides, size),
            note, summed=True,
            work=(_nbytes(g, rois) + level_bytes, samples * 256 * 4 * 2.0),
            plain_iters=2))
        _check_repeats(shapes, dtype, rois, g, strides, size)
    edge = torch.tensor(ROI_EDGE_CASES, dtype=torch.float32).cuda()
    valid = torch.ones(len(edge), dtype=torch.bool).cuda()
    valid[-1] = False
    for rois, valid, note in ((_crowded_rois(gen, 256), None,
                               '256 rois on 20x20 cells of P2'),
                              (edge, valid, 'edge-case rois')):
        for size in (7, 14):
            g = randn(rois.shape[0], size, size, 256).to(dtype)
            _compare('roi_align', dtype,
                     lambda: roi_align(feats[2], rois, strides, size,
                                       roi_valid=valid),
                     lambda: multilevel_roi_align(feats[2], rois, strides,
                                                  size, roi_valid=valid),
                     f'{note} {size}x{size}x256, batch 2', plain_iters=2)
            _compare('roi_align_bwd', dtype,
                     lambda: roi_align_bwd(shapes, dtype, rois, g, strides,
                                           size, roi_valid=valid),
                     lambda: multilevel_roi_align_backward(
                         shapes, dtype, rois, g, strides, size,
                         roi_valid=valid),
                     f'{note} {size}x{size}x256, batch 2', summed=True,
                     plain_iters=2)
            _check_repeats(shapes, dtype, rois, g, strides, size, valid)
    return dict(fwd[0], shapes=fwd), dict(bwd[0], shapes=bwd)


def _check_repeats(shapes, dtype, rois, g, strides, size, valid=None):
    """Two runs of the RoIAlign backward kernel give the same bits."""
    a, b = (roi_align_bwd(shapes, dtype, rois, g, strides, size,
                          roi_valid=valid) for _ in range(2))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f'roi_align_bwd {dtype} {rois.shape[0]} rois '
                             f'{size}x{size}: two runs differ')


def _nms_inputs(gen, b, n, groups):
    """Score-sorted NMS candidates as batched_nms hands them to the
    kernel: proposal-like boxes over an 800x1344 canvas, each shifted by
    its group's offset (RPN level or class) times (max coordinate + 1),
    uniform scores, 5 % of them invalid; sorted by a stable sort on the
    negated score."""
    boxes = _rois(gen, b * n).cpu()[:, 1:].reshape(b, n, 4)
    ids = torch.randint(0, groups, (b, n), generator=gen).float()
    boxes = boxes + (ids * (boxes.amax(dim=(1, 2))[:, None] + 1.0))[..., None]
    valid = torch.rand(b, n, generator=gen) > 0.05
    score = torch.where(valid, torch.rand(b, n, generator=gen), -torch.inf)
    order = torch.sort(-score, dim=1, stable=True).indices
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return [t.cuda().contiguous() for t in (
        boxes, torch.gather(score, 1, order), torch.gather(valid, 1, order),
        order)]


def _nms_work(args, out):
    """Bytes and fp32 operations that these candidates need: each input
    read once and each output written once; the IoUs of every kept box
    with the candidates after it (what the greedy scan must look at)."""
    boxes, _, _, order = args
    dets, inds, count = out
    n = order.shape[1]
    inv = torch.argsort(order, dim=1)
    pairs = 0
    for b in range(order.shape[0]):
        pos = inv[b][inds[b, :int(count[b])]]
        pairs += int((n - 1 - pos).sum())
    return (_nbytes(*args) + _nbytes(*out), NMS_OPS_PER_IOU * pairs,
            PEAK_FP32)


def _nms_blocks(args, out, max_out):
    """The 64-box blocks that the scan visits per image on these
    candidates: through the block of the last kept box where max_out were
    kept, else all of them."""
    order = args[3]
    _, inds, count = out
    inv = torch.argsort(order, dim=1)
    blocks = []
    for b in range(order.shape[0]):
        k = int(count[b])
        blocks.append(int(inv[b][inds[b, k - 1]]) // 64 + 1
                      if k == max_out and k else -(-order.shape[1] // 64))
    return blocks


def _kernel_device_ms(fn, keys, iters=10):
    """Device ms per call of fn() by kernel, from torch.profiler over
    ``iters`` calls: {key: the summed time of the kernels whose name holds
    keys[key]}. A session that records no device event at all (the
    profiler has dropped a whole session on the card, three in a row once)
    is taken again after a pause, up to five times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(6):
        if attempt:
            log('kernels', '  the profiler recorded no device event; again')
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_time_total > 0]
        if events:
            break
    return {key: sum(e.device_time_total for e in events if name in e.key)
            / 1e3 / iters for key, name in keys.items()}


def _swin_chain(qmap, bias, mask, nh, shift, ws=7):
    """The unfused chain of row 15 in qmap's dtype: torch.roll, window
    partition, SDPA with the bias and the shift mask as one additive mask
    (made here, outside the timed call), window reverse; rolled
    coordinates, as the kernel's. The yardstick of row 15's kernels."""
    _, hp, wp, c3 = qmap.shape
    c, nwy, nwx = c3 // 3, hp // ws, wp // ws
    add = bias[None] if mask is None else bias[None] + mask[:, None]
    add = add.to(qmap.dtype)

    def chain():
        x = torch.roll(qmap, (-shift, -shift), (1, 2))
        q, k, v = x.view(1, nwy, ws, nwx, ws, c3).permute(0, 1, 3, 2, 4, 5) \
            .reshape(-1, ws * ws, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=add)
        return o.transpose(1, 2).reshape(1, nwy, nwx, ws, ws, c) \
            .permute(0, 1, 3, 2, 4, 5).reshape(1, hp, wp, c)
    return chain


def _swin_blockwise(qmap, bias, mask, nh, shift, ws=7):
    """The port's own blockwise path for row 15's attention: the
    backbone's roll + partition gather (window_gather_indices), row 2's
    wrapper with the shift mask, and the inverse gather, which also
    un-rolls. A yardstick of the fused kernel's worth."""
    _, hp, wp, c3 = qmap.shape
    idx, _, inv_idx = (torch.from_numpy(t).to(qmap.device)
                       for t in window_gather_indices(hp, wp, ws, shift))

    def blockwise():
        wins = qmap.view(1, hp * wp, c3)[:, idx].view(-1, ws * ws, c3)
        o = window_attention_v3(wins, bias, mask, nh)
        return o.view(1, hp * wp, c3 // 3)[:, inv_idx] \
            .view(1, hp, wp, c3 // 3)
    return blockwise


def swin_checks(dtype, randn):
    """Row 15 on the padded map of one image at the four Swin stages of
    an 800x1344 canvas with shift 3, and at stage 1 with no shift: each
    held to its plain version, with the kernel's profiler device ms, the
    unfused chain (unfused_ms) and the port's blockwise path (blockwise_ms,
    its output un-rolled, so held to the un-rolled kernel output; events
    and device ms of all their kernels). In bf16 every launch must be the
    tensor-core kernel's, in fp32 the SIMT kernel's. Returns stage 1 with
    shift 3 and every row under ``shapes``."""
    bf16 = dtype == torch.bfloat16
    peak = PEAK_FLOPS if bf16 else PEAK_FP32
    before = swin_window_attention.launches, swin_window_attention.tc_launches
    rows = []
    for (windows, c, nh, (hp, wp)), shift in (
            [(st, 3) for st in ATTN_STAGES] + [(ATTN_STAGES[0], 0)]):
        qmap = randn(1, hp, wp, 3 * c).to(dtype)
        bias = randn(nh, 49, 49, scale=0.5)
        mask = None if shift == 0 else torch.from_numpy(
            shifted_window_attn_mask(hp, wp, 7, shift)).to(qmap.device)
        fn = lambda: swin_window_attention(qmap, bias, 7, shift, nh)  # noqa
        r = _compare('swin_window_attention', dtype, fn,
                     lambda: swin_attention_reference(qmap, bias, 7, shift,
                                                      nh),
                     f'(1, {hp}, {wp}, 3x{c}) shift {shift}',
                     work=(_nbytes(qmap, bias) + _nbytes(qmap) // 3,
                           _attn_flops(windows, 49, c, 2), peak))
        r['device_ms'] = _kernel_device_ms(fn, {'k': 'swindet'})['k']
        got = fn()
        for name, yard, want in (
                ('unfused', _swin_chain(qmap, bias, mask, nh, shift), got),
                ('blockwise', _swin_blockwise(qmap, bias, mask, nh, shift),
                 torch.roll(got, (shift, shift), (1, 2)))):
            err = (yard().float() - want.float()).abs().max().item()
            atol, rtol = TOL[dtype]
            if not err <= atol + rtol * want.float().abs().max().item():
                raise AssertionError(f'swin_window_attention {dtype}: the '
                                     f'{name} yardstick differs by {err:.3g}')
            r[f'{name}_ms'] = cuda_ms(yard, iters=20)
            r[f'{name}_device_ms'] = _kernel_device_ms(yard,
                                                       {'k': ''})['k']
        log('kernels', f'  device ms: kernel {r["device_ms"]:.4f}, unfused '
                       f'chain {r["unfused_device_ms"]:.4f} (events '
                       f'{r["unfused_ms"]:.4f}), blockwise path '
                       f'{r["blockwise_device_ms"]:.4f} (events '
                       f'{r["blockwise_ms"]:.4f})')
        rows.append(r)
        del qmap, got
    launched = swin_window_attention.launches - before[0]
    launched_tc = swin_window_attention.tc_launches - before[1]
    log('kernels', f'  swin_window_attention: {launched} launches, '
                   f'{launched_tc} tensor-core')
    if launched_tc != (launched if bf16 else 0):
        raise AssertionError('swin_window_attention: bf16 must run the '
                             'tensor-core kernel and fp32 the SIMT one')
    return dict(rows[0], shapes=rows)


def _mlp_inputs(randn, rows, c, dtype):
    """x (rows, C) and the weights of a Swin token MLP (H = 4C) in dtype,
    fp32 biases, and the output gradient."""
    h = 4 * c
    return (randn(rows, c).to(dtype), randn(h, c, scale=c ** -0.5).to(dtype),
            randn(h, scale=0.1), randn(c, h, scale=h ** -0.5).to(dtype),
            randn(c, scale=0.1), randn(rows, c).to(dtype))


def _unfused_mlp(x, w1, b1, w2, b2):
    """The unfused chain in x's dtype (cuBLAS GEMMs, the hidden in device
    memory): the yardstick of the fused kernels."""
    return F.linear(F.gelu(F.linear(x, w1, b1.to(x.dtype))), w2,
                    b2.to(x.dtype))


def _unfused_mlp_bwd(x, w1, b1, w2, b2, g):
    """A function that runs the backward of the unfused chain's graph
    (built once here), the yardstick of the fused backward."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, w1, b1, w2,
                                                           b2)]
    out = _unfused_mlp(*leaves)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def _mlp_bwd_limits(bwd, want):
    """The limits of a bf16 run's fp32 weight gradients (dw1, db1, dw2)
    of the fused backward on the inputs ``bwd``, given the plain version's
    outputs ``want``: each the larger of TOL_SUM[fp32] of its largest entry
    and ORDER_SPREAD_FACTOR times its summation-order spread on these
    inputs (ops/fused_mlp.py). The plain version with the first 64-row
    tile of g zeroed, a kernel that dropped a tile, must exceed every one
    of them, or the limits could not tell."""
    limits = fused_mlp_bwd_limits(*bwd, want, floor=TOL_SUM[torch.float32])
    g = bwd[-1].clone()
    g[:64] = 0
    control = fused_mlp_bwd_reference(*bwd[:-1], g)
    errs = [(a - w).abs().max().item()
            for a, w in zip(control[1:4], want[1:4])]
    log('kernels', '  weight-gradient limits (dw1, db1, dw2): '
                   + ', '.join(f'{lim:.3g}' for lim in limits)
                   + '; control with a 64-row tile of g zeroed: '
                   + ', '.join(f'{e:.3g}' for e in errs))
    if any(e <= lim for e, lim in zip(errs, limits)):
        raise AssertionError('fused_mlp_bwd: the zeroed-tile control '
                             'passes the derived limits')
    return limits


def _sdpa_inputs(qkv, bias, mask, nh):
    """q, k, v (B_, nH, N, hd) views of the packed qkv and the additive
    bias + mask in qkv's dtype, for the library yardstick."""
    b_, n, c3 = qkv.shape
    q, k, v = qkv.view(b_, n, 3, nh, c3 // 3 // nh).permute(2, 0, 3, 1, 4)
    add = bias[None].expand(b_, -1, -1, -1)
    if mask is not None:
        add = (add.reshape(b_ // mask.shape[0], mask.shape[0], nh, n, n)
               + mask[None, :, None]).reshape(b_, nh, n, n)
    return q, k, v, add.to(qkv.dtype).contiguous()


def _sdpa_bwd(qkv, bias, mask, nh, g):
    """A function that runs the autograd backward of SDPA's graph (built
    once here) with q, k, v and the fp32 bias as leaves, the bias added
    to every window with the mask (so dBias sums over the windows): the
    yardstick of row 7."""
    b_, n, c3 = qkv.shape
    hd = c3 // 3 // nh
    leaves = [t.detach().contiguous().requires_grad_()
              for t in qkv.view(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)]
    leaves.append(bias.detach().clone().requires_grad_())
    add = _sdpa_inputs(qkv, leaves[3], mask, nh)[3]
    out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=add)
    go = g.view(b_, n, nh, hd).transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, go, retain_graph=True)


def _v4_inputs(randn, b_, c, dtype):
    """x (B_, 49, C) in dtype, the fp32 projections of a Swin block (nn.Linear
    layout) and an output gradient in dtype."""
    return (randn(b_, 49, c).to(dtype), randn(3 * c, c, scale=c ** -0.5),
            randn(3 * c, scale=0.1), randn(c, c, scale=c ** -0.5),
            randn(c, scale=0.1), randn(b_, 49, c).to(dtype))


def _unfused_v4(x, wqkv, bqkv, bias, mask, wproj, bproj, nh):
    """The unfused chain in x's dtype: F.linear -> SDPA with the additive
    bias and mask -> F.linear (cuBLAS and a library attention, qkv and the
    attention output in device memory): the yardstick of the v4 kernels.
    The weights are cast beforehand, outside the timed call."""
    b_, n, c = x.shape
    q, k, v, add = _sdpa_inputs(F.linear(x, wqkv, bqkv), bias, mask, nh)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=add)
    return F.linear(out.transpose(1, 2).reshape(b_, n, c), wproj, bproj)


def _unfused_v4_bwd(x, wqkv, bqkv, bias, mask, wproj, bproj, nh, g):
    """A function that runs the backward of the unfused chain's graph
    (built once here), the yardstick of the v4 backward."""
    d = x.dtype
    leaves = [t.detach().to(d).clone().requires_grad_()
              for t in (x, wqkv, bqkv, wproj, bproj)]
    bias = bias.detach().clone().requires_grad_()
    out = _unfused_v4(leaves[0], leaves[1], leaves[2], bias, mask,
                      leaves[3], leaves[4], nh)
    return lambda: torch.autograd.grad(out, leaves + [bias], g,
                                       retain_graph=True)


def _v4_bwd_check(bwd, bproj):
    """Row 13's bf16 check on the inputs ``bwd``: the limits of its fp32
    outputs (dWqkv, dbqkv, dBias, dWproj, dbproj) against the plain
    version with the tensor-core kernels' roundings, each the largest of
    TOL_SUM[fp32] of its largest entry, ORDER_SPREAD_FACTOR (4) times its
    summation-order spread on these inputs and the change one rounding
    flip can make (ops/window_attention_v4.py). That plain version with
    the first 64-row tile of g zeroed, a kernel that dropped a tile, must
    exceed every one. Logs beside them the grade of a bf16 run: the
    kernel's distance to the fp32 plain version and that of the bf16
    autograd of the unfused chain, as shares of each output's largest
    entry. Returns the six outputs' limits (None for dx, held to
    TOL_SUM[bf16])."""
    x, wqkv, bqkv, bias, mask, wproj, g, nh = bwd
    want = window_attention_v4_bwd_reference(*bwd, tc_rounding=True)
    limits = window_attention_v4_bwd_limits(*bwd, want,
                                            floor=TOL_SUM[torch.float32])
    dropped = g.clone()
    dropped.view(-1, x.shape[-1])[:64] = 0
    control = window_attention_v4_bwd_reference(*bwd[:-2], dropped, nh,
                                                tc_rounding=True)
    errs = [(a - w).abs().max().item()
            for a, w in zip(control[1:], want[1:])]
    del want, control, dropped

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    fp32 = window_attention_v4_bwd_reference(*bwd)
    got = window_attention_v4_bwd(*bwd)
    chain = _unfused_v4_bwd(x, wqkv, bqkv, bias, mask, wproj, bproj, nh,
                            g)()
    chain = [chain[i] for i in (0, 1, 2, 5, 3, 4)]
    log('kernels', '  fp32-output limits (dWqkv, dbqkv, dBias, dWproj, '
                   'dbproj): ' + ', '.join(f'{lim:.3g}' for lim in limits)
                   + '; control with a 64-row tile of g zeroed: '
                   + ', '.join(f'{e:.3g}' for e in errs))
    log('kernels', '  distance to the fp32 plain version / max|fp32| '
                   '(dx, dWqkv, dbqkv, dBias, dWproj, dbproj): kernel '
                   + ', '.join(f'{rel(a, f):.2g}' for a, f in zip(got, fp32))
                   + '; bf16 autograd of the unfused chain '
                   + ', '.join(f'{rel(a, f):.2g}'
                               for a, f in zip(chain, fp32)))
    if any(e <= lim for e, lim in zip(errs, limits)):
        raise AssertionError('window_attention_v4_bwd: the zeroed-tile '
                             'control passes the derived limits')
    return [None, *limits]


def _v4_flops(b_, c, backward=False):
    """Operations of the v4 function on B_ windows of 49 tokens: the qkv
    and output projections (8 N C^2 a window) and the two attention
    products; the backward recomputes qkv, P and the attention output and
    adds d(attn), dWproj, dWqkv and dx (22 N C^2 in all) and the four
    products of the attention backward."""
    rows = b_ * 49
    if backward:
        return 22.0 * rows * c * c + _attn_flops(b_, 49, c, 6)
    return 8.0 * rows * c * c + _attn_flops(b_, 49, c, 2)


def _conv_compare(dtype, x, cw, cb, relu=False):
    """Row 3 (``conv3x3``) on x (B, H, W, C) with cw (3, 3, C, Co) and cb
    against its plain version, with its bound and the library call on
    channels-last views (F.conv2d, without the ReLU where the kernel fuses
    one)."""
    (b, h, w, c), co = x.shape, cw.shape[3]
    x_nchw, w_oihw = x.permute(0, 3, 1, 2), cw.permute(3, 2, 0, 1)
    cbd = cb.to(dtype)
    return _compare('conv3x3', dtype, lambda: conv3x3(x, cw, cb, relu),
                    lambda: conv3x3_reference(x, cw, cb, relu),
                    f'({b}, {h}, {w}, {c}->{co})' + (' relu' if relu else ''),
                    work=(_nbytes(x) + b * h * w * co * x.element_size()
                          + _nbytes(cw, cb), 2.0 * 9 * c * co * b * h * w),
                    library_fn=lambda: F.conv2d(x_nchw, w_oihw, cbd,
                                                padding=1))


def _dw_compare(dtype, x, g):
    """Row 8 (``conv3x3_dw``) on x (B, H, W, C) and g (B, H, W, Co)
    against its plain version, with its bound and
    torch.nn.grad.conv2d_weight on channels-last views."""
    (b, h, w, c), co = x.shape, g.shape[3]
    x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    return _compare('conv3x3_dw', dtype, lambda: conv3x3_dw(x, g),
                    lambda: conv3x3_dw_reference(x, g),
                    f'({b}, {h}, {w}, {c}->{co})', summed=True,
                    work=(_nbytes(x, g) + 9 * c * co * 4,
                          2.0 * 9 * c * co * b * h * w),
                    library_fn=lambda: torch.nn.grad.conv2d_weight(
                        x_nchw, (co, c, 3, 3), g_nchw, padding=1))


def zoo_kernel_checks(dtype, gen, randn):
    """Rows 3, 8, 4 and 9 at the widths of phase 15's C4 and DC5 configs,
    each against its plain version with its bound: the RPN conv (ReLU) and
    its filter gradient on the stride-16 map of an 800x1344 canvas, 50x84,
    batch 1 and 2, at 1024 -> 1024 (C4) and 2048 -> 2048 (DC5) channels;
    RoIAlign on that one level at 14x14x1024 (C4) and 7x7x2048 (DC5) for
    1,000 rois (batch 1, serving) and 1,024 (batch 2, training: the rcnn
    sampler's 512 an image), its backward at the training shapes; C4's
    mask branch pools again through the same extractor, so 14x14x1024
    also runs both ways at 256 rois (batch 2, at most the sampler's 128
    positives an image). Returns the four lists of rows."""
    conv, dw, fwd, bwd = [], [], [], []
    el = torch.finfo(dtype).bits // 8
    for c in (1024, 2048):
        cw = randn(3, 3, c, c, scale=0.01).to(dtype)
        cb = randn(c)
        for b in (1, 2):
            x = randn(b, 50, 84, c).to(dtype)
            conv.append(_conv_compare(dtype, x, cw, cb, True))
            dw.append(_dw_compare(dtype, x, randn(b, 50, 84, c, scale=0.1)
                                  .to(dtype)))
        del cw, x
    for c, size, cases in ((1024, 14, ((1000, 1), (1024, 2), (256, 2))),
                           (2048, 7, ((1000, 1), (1024, 2)))):
        for n, b in cases:
            feats = [randn(b, 50, 84, c).to(dtype)]
            rois = _rois(gen, n, batch=b)
            touched, samples = _roi_work([(50, 84)], rois, (16,), size)
            note = f'{n} rois {size}x{size}x{c}, one level at stride 16, ' \
                f'batch {b}'
            fwd.append(_compare(
                'roi_align', dtype,
                lambda: roi_align(feats, rois, (16,), size),
                lambda: multilevel_roi_align(feats, rois, (16,), size),
                note, work=(touched * c * el + _nbytes(rois)
                            + n * size * size * c * el,
                            samples * c * 4 * 2.0), plain_iters=1))
            if b == 1:
                continue
            shapes = [tuple(feats[0].shape)]
            g = randn(n, size, size, c).to(dtype)
            bwd.append(_compare(
                'roi_align_bwd', dtype,
                lambda: roi_align_bwd(shapes, dtype, rois, g, (16,), size),
                lambda: multilevel_roi_align_backward(shapes, dtype, rois, g,
                                                      (16,), size),
                note, summed=True,
                work=(_nbytes(g, rois) + _nbytes(feats[0]),
                      samples * c * 4 * 2.0), plain_iters=1))
            _check_repeats(shapes, dtype, rois, g, (16,), size)
    torch.cuda.empty_cache()
    return conv, dw, fwd, bwd


def phase_kernels():
    gen = torch.Generator().manual_seed(0)
    dev = 'cuda'

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    results = {}
    strides = (4, 8, 16, 32)
    for dtype in (torch.bfloat16, torch.float32):
        el = torch.finfo(dtype).bits // 8
        # LayerNorm at the seven shapes of a request's 32 norms (the row's
        # main shape first: the patch embedding's and stage 1's), each with
        # its kernel's device ms beside the wrapper's event ms, then at
        # Swin-B's seven (the cascade's 56 norms)
        rows1 = []
        for n, c in LN_SHAPES + SWINB_LN_SHAPES:
            x = (randn(n, c) * 2 + 0.5).to(dtype)
            w, b = randn(c), randn(c)
            wd, bd = w.to(dtype), b.to(dtype)
            r = _compare('layer_norm', dtype, lambda: layer_norm(x, w, b),
                         lambda: layer_norm_reference(x, w, b),
                         f'({n}, {c})',
                         work=(2 * _nbytes(x) + _nbytes(w, b),
                               8.0 * x.numel()),
                         library_fn=lambda: F.layer_norm(x, (c,), wd, bd))
            if (n, c) in LN_SHAPES:
                r['device_ms'] = _kernel_device_ms(
                    lambda: layer_norm(x, w, b), {'k': 'swindet'})['k']
                log('kernels', f'  device ms {r["device_ms"]:.4f}')
            rows1.append(r)
        # the first kernel (a warp a row), which takes the widths that are
        # no multiple of the vector and bases off 16 bytes: the main
        # shape's x copied one element past a 16-byte boundary
        x = (randn(*LN_SHAPES[0]) * 2 + 0.5).to(dtype)
        w, b = randn(x.shape[1]), randn(x.shape[1])
        off = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:] \
            .view(x.shape).copy_(x)
        first = _compare('layer_norm', dtype, lambda: layer_norm(off, w, b),
                         lambda: layer_norm_reference(x, w, b),
                         f'{tuple(x.shape)} off 16 bytes',
                         work=(2 * _nbytes(x) + _nbytes(w, b),
                               8.0 * x.numel()))
        dms = _kernel_device_ms(lambda: layer_norm(off, w, b),
                                {'first': 'layer_norm_kernel',
                                 'vec': 'layer_norm_vec_kernel'})
        if dms['first'] <= 0 or dms['vec'] > 0:
            raise AssertionError('layer_norm: a base off 16 bytes must run '
                                 f'the first kernel alone, profiler {dms}')
        first['device_ms'] = dms['first']
        log('kernels', f'  device ms {first["device_ms"]:.4f} (the first '
                       'kernel)')
        k = len(LN_SHAPES)
        results.setdefault('layer_norm', {})[dtype] = dict(
            rows1[0], shapes=rows1[:k], swin_b_shapes=rows1[k:],
            first_kernel=first)
        del x, off

        # window attention at the shifted blocks of stages 1-4 of an
        # 800x1344 canvas: the forward (row 2) at a request's windows, the
        # training forward (row 6) and the backward (row 7) at a training
        # batch's (twice as many); in bf16 (the tensor-core kernels) at
        # every stage, in fp32 (the SIMT kernels) at stages 1 and 4; for
        # Swin-T, then for Swin-B
        rows2, rows6, rows7 = [], [], []
        stages = (ATTN_STAGES, SWINB_ATTN_STAGES) if dtype == torch.bfloat16 \
            else (ATTN_STAGES[::3], SWINB_ATTN_STAGES[::3])
        for b_, c, nh, hw in stages[0] + stages[1]:
            mask = torch.from_numpy(
                shifted_window_attn_mask(*hw, 7, 3)).to(dev)
            bias = randn(nh, 49, 49, scale=0.5)
            qkv = randn(b_, 49, 3 * c).to(dtype)
            q, k, v, add = _sdpa_inputs(qkv, bias, mask, nh)
            rows2.append(_compare(
                'window_attention_v3', dtype,
                lambda: window_attention_v3(qkv, bias, mask, nh),
                lambda: window_attention_reference(qkv, bias, mask, nh),
                f'({b_}, 49, 3x{c}) {nh} heads shifted',
                work=(_nbytes(qkv, bias, mask) + _nbytes(qkv) // 3,
                      _attn_flops(b_, 49, c, 2)),
                library_fn=lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=add)))
            del qkv, q, k, v, add
            qkv2 = randn(2 * b_, 49, 3 * c).to(dtype)
            # out held to TOL[dtype] elementwise, the fp32 P to TOL[fp32]
            rows6.append(_compare(
                'window_attention_fwd_p', dtype,
                lambda: window_attention_fwd_p(qkv2, bias, mask, nh),
                lambda: window_attention_fwd_p_reference(qkv2, bias, mask,
                                                         nh),
                f'({2 * b_}, 49, 3x{c}) {nh} heads shifted',
                work=(_nbytes(qkv2, bias, mask) + _nbytes(qkv2) // 3
                      + nh * 2 * b_ * 49 * 49 * 4,
                      _attn_flops(2 * b_, 49, c, 2))))
            _, p = window_attention_fwd_p_reference(qkv2, bias, mask, nh)
            g = randn(2 * b_, 49, c).to(dtype)
            r = _compare('window_attention_bwd', dtype,
                         lambda: window_attention_bwd(qkv2, p, g, nh),
                         lambda: window_attention_bwd_reference(qkv2, p, g,
                                                                nh),
                         f'({2 * b_}, 49, 3x{c}) {nh} heads', summed=True,
                         work=(2 * _nbytes(qkv2) + _nbytes(p, g)
                               + nh * 49 * 49 * 4,
                               _attn_flops(2 * b_, 49, c, 5)))
            r['unfused_ms'] = cuda_ms(_sdpa_bwd(qkv2, bias, mask, nh, g),
                                      iters=20)
            log('kernels', f'  SDPA backward (autograd, q, k, v and the '
                           f'bias as leaves) {r["unfused_ms"]:.4f} ms')
            rows7.append(r)
            del qkv2, p, g
            torch.cuda.empty_cache()
        k = len(stages[0])
        for name, rows in (('window_attention_v3', rows2),
                           ('window_attention_fwd_p', rows6),
                           ('window_attention_bwd', rows7)):
            results.setdefault(name, {})[dtype] = dict(
                rows[0], shapes=rows[:k], swin_b_shapes=rows[k:])

        # 3x3 conv: the FPN output convs at P2 (the row's main shape) and,
        # in bf16 (the tensor-core kernel), P3-P5; in bf16 the RPN conv
        # (ReLU) at P6; the mask-head conv (ReLU) on 100 rois; RepPoints'
        # stacked head conv (ReLU) at P7, 7x11, its smallest level
        x = randn(1, 200, 336, 256).to(dtype)
        cw = randn(3, 3, 256, 256, scale=0.02).to(dtype)
        cb = randn(256)
        rows = [_conv_compare(dtype, x, cw, cb)]
        if dtype == torch.bfloat16:
            for (h, w), relu in [(hw, False) for hw in FPN_SHAPES[1:]] \
                    + [((13, 21), True)]:
                rows.append(_conv_compare(dtype, randn(1, h, w, 256).to(
                    dtype), cw, cb, relu))
        xm = randn(100, 14, 14, 256).to(dtype)
        rows.append(_conv_compare(dtype, xm, cw, cb, True))
        rows.append(_conv_compare(dtype, randn(1, 7, 11, 256).to(dtype), cw,
                                  cb, True))
        results.setdefault('conv3x3', {})[dtype] = dict(rows[0], shapes=rows)

        # its filter gradient: FPN P2 of a batch of 2; mask head, 256 rois;
        # RepPoints' head at P7 of a batch of 2
        x2 = randn(2, 200, 336, 256).to(dtype)
        g2 = randn(2, 200, 336, 256, scale=0.1).to(dtype)
        rows = [_dw_compare(dtype, x2, g2)]
        del x2, g2
        xm2 = randn(256, 14, 14, 256).to(dtype)
        gm2 = randn(256, 14, 14, 256, scale=0.1).to(dtype)
        rows.append(_dw_compare(dtype, xm2, gm2))
        rows.append(_dw_compare(dtype, randn(2, 7, 11, 256).to(dtype),
                                randn(2, 7, 11, 256, scale=0.1).to(dtype)))
        results.setdefault('conv3x3_dw', {})[dtype] = dict(rows[0],
                                                           shapes=rows)
        del x, xm, xm2, gm2
        torch.cuda.empty_cache()

        results.setdefault('roi_align', {})[dtype], \
            results.setdefault('roi_align_bwd', {})[dtype] = \
            roi_checks(dtype, gen, randn)
        torch.cuda.empty_cache()
        # phase 15's C4 and DC5 widths, added to each row's shapes
        for key, rows in zip(('conv3x3', 'conv3x3_dw', 'roi_align',
                              'roi_align_bwd'),
                             zoo_kernel_checks(dtype, gen, randn)):
            results[key][dtype]['shapes'] = \
                results[key][dtype].get('shapes', []) + rows

        # fused MLP: in bf16 (the tensor-core kernels) the forward at the
        # serving rows of stages 1-3 and the training rows of stage 1, the
        # backward at the training rows of stages 1-3; in fp32 (the SIMT
        # kernels) stages 1 and 3
        fwd = ((67200, 96), (16800, 192), (4200, 384), (134400, 96)) \
            if dtype == torch.bfloat16 else ((67200, 96), (4200, 384))
        rows = []
        for n, c in fwd:
            x, w1, b1, w2, b2, _ = _mlp_inputs(randn, n, c, dtype)
            mlp = (x, w1, b1, w2, b2)
            r = _compare('fused_mlp', dtype, lambda: fused_mlp(*mlp),
                         lambda: fused_mlp_reference(*mlp),
                         f'({n}, {c}) H {4 * c}',
                         work=(_nbytes(*mlp) + _nbytes(x),
                               4.0 * n * c * 4 * c))
            r['unfused_ms'] = cuda_ms(lambda: _unfused_mlp(*mlp), iters=20)
            log('kernels', f'  unfused F.linear -> F.gelu -> F.linear '
                           f'{r["unfused_ms"]:.4f} ms')
            rows.append(r)
        results.setdefault('fused_mlp', {})[dtype] = dict(rows[0],
                                                          shapes=rows)
        rows = []
        for n, c in ((134400, 96), (33600, 192), (8400, 384)) \
                if dtype == torch.bfloat16 else ((134400, 96), (8400, 384)):
            x, w1, b1, w2, b2, g = _mlp_inputs(randn, n, c, dtype)
            bwd = (x, w1, b1, w2, g)
            want = fused_mlp_bwd_reference(*bwd)
            limits = None
            if dtype == torch.bfloat16:
                limits = [None, *_mlp_bwd_limits(bwd, want), None]
            r = _compare('fused_mlp_bwd', dtype, lambda: fused_mlp_bwd(*bwd),
                         lambda: fused_mlp_bwd_reference(*bwd),
                         f'({n}, {c}) H {4 * c}', summed=True,
                         limits=limits,
                         work=(_nbytes(*bwd) + _nbytes(x)
                               + 4 * (2 * 4 * c * c + 5 * c),
                               10.0 * n * c * 4 * c))
            del want
            r['unfused_ms'] = cuda_ms(_unfused_mlp_bwd(x, w1, b1, w2, b2, g),
                                      iters=20)
            log('kernels', f'  unfused backward (autograd of the chain) '
                           f'{r["unfused_ms"]:.4f} ms')
            rows.append(r)
        results.setdefault('fused_mlp_bwd', {})[dtype] = dict(rows[0],
                                                              shapes=rows)
        del x, g, mlp, bwd
        torch.cuda.empty_cache()

        # v4 attention (qkv projection, attention, output projection in one
        # kernel, row 12, and its backward, row 13): in bf16 (the
        # tensor-core kernels, bound at the bf16 tensor-core rate) at every
        # stage, in fp32 (the SIMT kernels, bound at the fp32 CUDA-core
        # rate) at stages 1 and 4; the forward at a request's windows, the
        # backward at a training batch's, with the stage's shift mask. The
        # bf16 backward is held to the plain version with the tensor-core
        # kernels' roundings (_v4_bwd_check).
        bf16 = dtype == torch.bfloat16
        peak = PEAK_FLOPS if bf16 else PEAK_FP32
        rows12, rows13 = [], []
        for b_, c, nh, hw in ATTN_STAGES if bf16 else ATTN_STAGES[::3]:
            mask = torch.from_numpy(
                shifted_window_attn_mask(*hw, 7, 3)).to(dev)
            bias = randn(nh, 49, 49, scale=0.5)
            x, wqkv, bqkv, wproj, bproj, _ = _v4_inputs(randn, b_, c, dtype)
            v4 = (x, wqkv, bqkv, bias, mask, wproj, bproj, nh)
            r = _compare('window_attention_v4', dtype,
                         lambda: window_attention_v4(*v4),
                         lambda: window_attention_v4_reference(
                             x.float(), *v4[1:]).to(dtype),
                         f'({b_}, 49, {c}) {nh} heads shifted',
                         work=(2 * _nbytes(x) + _nbytes(wqkv, bqkv, bias,
                                                        wproj, bproj, mask),
                               _v4_flops(b_, c), peak))
            cast = [t.to(dtype) for t in (wqkv, bqkv, wproj, bproj)]
            r['unfused_ms'] = cuda_ms(lambda: _unfused_v4(
                x, cast[0], cast[1], bias, mask, cast[2], cast[3], nh),
                iters=20)
            log('kernels', f'  unfused F.linear -> SDPA -> F.linear '
                           f'{r["unfused_ms"]:.4f} ms')
            rows12.append(r)
            del x, v4, cast
            x, wqkv, bqkv, wproj, bproj, g = _v4_inputs(randn, 2 * b_, c,
                                                        dtype)
            bwd = (x, wqkv, bqkv, bias, mask, wproj, g, nh)
            limits = _v4_bwd_check(bwd, bproj) if bf16 else None
            r = _compare('window_attention_v4_bwd', dtype,
                         lambda: window_attention_v4_bwd(*bwd),
                         lambda: window_attention_v4_bwd_reference(
                             *bwd, tc_rounding=bf16),
                         f'({2 * b_}, 49, {c}) {nh} heads shifted',
                         summed=True, limits=limits,
                         work=(3 * _nbytes(x) + 2 * _nbytes(
                             wqkv, bqkv, bias, wproj, bproj) + _nbytes(mask),
                               _v4_flops(2 * b_, c, backward=True), peak))
            r['unfused_ms'] = cuda_ms(_unfused_v4_bwd(
                x, wqkv, bqkv, bias, mask, wproj, bproj, nh, g), iters=20)
            log('kernels', f'  unfused backward (autograd of the chain) '
                           f'{r["unfused_ms"]:.4f} ms')
            rows13.append(r)
            del x, g, bwd
            torch.cuda.empty_cache()
        results.setdefault('window_attention_v4', {})[dtype] = dict(
            rows12[0], shapes=rows12)
        results.setdefault('window_attention_v4_bwd', {})[dtype] = dict(
            rows13[0], shapes=rows13)

        # the v1 attention over head-major q, k, v (row 14; in bf16 its
        # tensor-core kernel, in fp32 the SIMT one) and the full-map shifted
        # attention, which no model path runs: stage 1 of one image. Row
        # 14's wrapper makes the head-major copy before its kernel: the
        # profiler splits the kernel's device ms from the copy's.
        mask = torch.from_numpy(
            shifted_window_attn_mask(203, 336, 7, 3)).to(dev)
        qkv = randn(1392, 49, 288).to(dtype)
        bias = randn(3, 49, 49, scale=0.5)
        q, k, v, add = _sdpa_inputs(qkv, bias, mask, 3)
        before = window_attention.launches, window_attention.tc_launches
        r = _compare(
            'window_attention', dtype,
            lambda: window_attention(qkv, bias, mask, 3),
            lambda: window_attention_reference(qkv, bias, mask, 3),
            '(1392, 49, 3x96) shifted',
            work=(_nbytes(qkv, bias, mask) + _nbytes(qkv) // 3,
                  _attn_flops(1392, 49, 96, 2)),
            library_fn=lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=add))
        dms = _kernel_device_ms(lambda: window_attention(qkv, bias, mask, 3),
                                {'device_ms': 'swindet', 'all': ''})
        r['device_ms'] = dms['device_ms']
        r['copy_device_ms'] = dms['all'] - dms['device_ms']
        launched = window_attention.launches - before[0]
        launched_tc = window_attention.tc_launches - before[1]
        log('kernels', f'  device ms: kernel {r["device_ms"]:.4f}, '
                       f'head-major copy {r["copy_device_ms"]:.4f}; '
                       f'{launched} launches, {launched_tc} tensor-core')
        if launched_tc != (launched if dtype == torch.bfloat16 else 0):
            raise AssertionError('window_attention: bf16 must run the '
                                 'tensor-core kernel and fp32 the SIMT one')
        results.setdefault('window_attention', {})[dtype] = r
        del qkv, q, k, v, add
        results.setdefault('swin_window_attention', {})[dtype] = \
            swin_checks(dtype, randn)

        # NMS on fp32 boxes (the same in both configurations): RPN when
        # serving and in a training step, the bbox head's multiclass NMS,
        # the C4 RPN's one level (nms_pre 12,000, max_per_img 2,000,
        # configs/_base_/models/rpn_r50_caffe_c4.py); its mask and scan
        # kernels' device times apart
        if dtype == torch.float32:
            rows = []
            for b, n, groups, thr, max_out, note in (
                    (2, 8819, 5, 0.7, 1000, 'RPN train'),
                    (1, 4819, 5, 0.7, 1000, 'RPN serve'),
                    (1, 2048, 80, 0.5, 100, 'multiclass'),
                    (1, 12000, 1, 0.7, 2000, 'C4 RPN serve')):
                args = _nms_inputs(gen, b, n, groups)
                out = nms_sorted_reference(*args, thr, max_out)
                r = _compare('nms_sorted', dtype,
                             lambda: nms_sorted(*args, thr, max_out),
                             lambda: nms_sorted_reference(*args, thr,
                                                          max_out),
                             f'B {b} N {n} IoU {thr} max {max_out} ({note}, '
                             f'{[int(k) for k in out[2]]} kept)',
                             work=_nms_work(args, out), exact=True)
                r.update(_kernel_device_ms(
                    lambda: nms_sorted(*args, thr, max_out),
                    {'mask_device_ms': 'nms_mask_kernel',
                     'scan_device_ms': 'nms_scan_kernel'}))
                r['scan_blocks'] = _nms_blocks(args, out, max_out)
                log('kernels', f'  device ms: mask {r["mask_device_ms"]:.4f}'
                               f', scan {r["scan_device_ms"]:.4f}; 64-box '
                               f'blocks the scan visited per image '
                               f'{r["scan_blocks"]} of {-(-n // 64)}')
                rows.append(r)
            results['nms_sorted'] = {dtype: dict(rows[0], shapes=rows)}
            del args, out
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------- phase 4
def synthetic_images(n, h=800, w=1333, seed=0, with_boxes=False):
    """Seeded noise with painted rectangles (bench.py's input recipe), as
    BGR uint8 images; with ``with_boxes`` also each image's rectangles
    (16, 4) as x1, y1, x2, y2."""
    rs = np.random.RandomState(seed)
    imgs, boxes = [], []
    for _ in range(n):
        raw = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        rects = []
        for _ in range(16):
            y0, x0 = rs.randint(0, h - 64), rs.randint(0, w - 64)
            bh, bw = rs.randint(24, 256), rs.randint(24, 256)
            raw[y0:min(y0 + bh, h), x0:min(x0 + bw, w)] = \
                rs.randint(0, 256, 3)
            rects.append((x0, y0, min(x0 + bw, w), min(y0 + bh, h)))
        imgs.append(raw)
        boxes.append(np.array(rects, np.float32))
    return (imgs, boxes) if with_boxes else imgs


def _check_result(res, h, w):
    bbox_res, mask_res = res
    if len(bbox_res) != 80 or len(mask_res) != 80:
        raise AssertionError('expected 80 classes of results')
    n = 0
    for dets, masks in zip(bbox_res, mask_res):
        if dets.ndim != 2 or dets.shape[1] != 5 \
                or not np.isfinite(dets).all():
            raise AssertionError(f'bad detections {dets.shape}')
        if len(masks) != len(dets) or any(m.shape != (h, w) for m in masks):
            raise AssertionError('masks do not match detections')
        n += len(dets)
    # seeded heads score every class near 1/81, under score_thr 0.05, so
    # few or no boxes survive; phase 5 checks detections with spread heads
    if n > 100:
        raise AssertionError(f'{n} detections, over max_per_img 100')
    return n


@contextlib.contextmanager
def env_switch(name):
    """A configuration of the JAX package's switches: ``name``=1
    (SWINDET_FUSED_MLP, read by every Mlp built inside, or
    SWINDET_WATTN_V4, read by every WindowAttention)."""
    os.environ[name] = '1'
    try:
        yield
    finally:
        del os.environ[name]


def _fused_blocks(model):
    """How many token MLPs of the model run fused."""
    return sum(bool(getattr(m, 'fused', False)) for m in model.modules())


def _check_blocks(model, fused, v4):
    """Swin-T's configuration as built: 10 fused token MLPs (stages 1-3)
    with the fused-MLP switch, 12 v4 attention blocks with the v4 switch,
    none otherwise."""
    v4_blocks = sum(m.v4 for m in model.modules()
                    if isinstance(m, WindowAttention))
    got = (_fused_blocks(model), v4_blocks)
    if got != (10 if fused else 0, 12 if v4 else 0):
        raise AssertionError(f'{got[0]} fused token MLPs, {got[1]} v4 '
                             f'attention blocks')
    return got


def _serving_kernels(v4):
    """The kernels a request must launch: the inference kernels, with the
    v4 forward in place of the v3 one in the v4 configuration."""
    return tuple(window_attention_v4 if v4 and fn is window_attention_v3
                 else fn for fn in INFERENCE_KERNELS)


# kernels that serving and a validation pass must not launch
NOT_SERVING = TRAINING_KERNELS + (fused_mlp_bwd, window_attention_v4_bwd) \
    + OP_ONLY_KERNELS


def _tc_kernels(fused, training=True, v4=False):
    """The wrappers with a tensor-core kernel that a run launches: the
    conv forward and, in training, its filter gradient; outside the v4
    configuration the v3 attention's inference forward (serving) or its
    training forward and backward (training), in it the v4 forward and,
    in training, its backward; in the fused-MLP configuration the fused
    forward and, in training, its backward."""
    kernels = (conv3x3, conv3x3_dw) if training else (conv3x3,)
    if not v4:
        kernels += (window_attention_fwd_p, window_attention_bwd) \
            if training else (window_attention_v3,)
    else:
        kernels += WATTN_V4_KERNELS if training else (window_attention_v4,)
    if fused:
        kernels += FUSED_MLP_KERNELS if training else (fused_mlp,)
    return kernels


def _check_tc(what, launches, bf16, wanted):
    """The conv, fused-MLP and v3 and v4 attention wrappers pick their
    kernel by dtype (the attentions' also by head width, 32 at every
    stage): in a bf16 run every launch is a tensor-core one, and each of
    ``wanted`` launched; in an fp32 run none is. Returns the tensor-core
    counts."""
    tc = tc_launch_counts()
    want = {fn.__name__: launches[fn.__name__] if bf16 else 0
            for fn in TENSOR_CORE_KERNELS}
    idle = [fn.__name__ for fn in wanted if not launches[fn.__name__]]
    if tc != want or idle:
        raise AssertionError(f'{what}: tensor-core launches {tc}, expected '
                             f'{want}; not launched: {idle}')
    return tc


def phase_main(phase='main', fused=False, v4=False):
    opts = {'model.test_cfg.rpn.nms_pre': 1000,
            'model.test_cfg.rpn.max_per_img': 1000}
    t0 = time.perf_counter()
    model = init_detector(CONFIG, device='cuda', cfg_options=opts, seed=0)
    blocks, v4_blocks = _check_blocks(model, fused, v4)
    log(phase, f'init_detector: {type(model).__name__} '
               f'{sum(p.numel() for p in model.parameters())} params, '
               f'compute {model.dtype}, {blocks} fused token MLPs, '
               f'{v4_blocks} v4 attention blocks, '
               f'{time.perf_counter() - t0:.1f} s')
    imgs = synthetic_images(3)
    t0 = time.perf_counter()
    _check_result(inference_detector(model, imgs[0]), 800, 1333)
    torch.cuda.synchronize()
    log(phase, f'warm-up request {time.perf_counter() - t0:.3f} s')

    reset_launch_counts()
    lat = []
    counts = []
    for img in imgs:
        t0 = time.perf_counter()
        res = inference_detector(model, img)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        counts.append(_check_result(res, 800, 1333))
    launches = launch_counts()
    log(phase, 'per-image latency (s): '
               + ', '.join(f'{t:.4f}' for t in lat)
               + f'; detections per image: {counts}')
    log(phase, f'kernel launches over the 3 requests: {launches}')
    tc = _check_tc(phase, launches, True, _tc_kernels(fused, False, v4))
    log(phase, f'of which tensor-core kernels: {tc}')
    idle = [fn.__name__ for fn in _serving_kernels(v4)
            if launches[fn.__name__] == 0]
    if idle:
        raise AssertionError(f'kernels not launched on the main path: '
                             f'{idle}')
    # serving must not pay for the training forward's softmax writes
    trained = [fn.__name__ for fn in NOT_SERVING if launches[fn.__name__]]
    if trained:
        raise AssertionError(f'training kernels launched while serving: '
                             f'{trained}')
    # NMS twice a request (RPN proposals, multiclass NMS); the fused
    # forward once per fused block; the attention forward, v3 or v4, once
    # per Swin block
    want = {'nms_sorted': 2 * len(imgs),
            'fused_mlp': (10 if fused else 0) * len(imgs),
            'window_attention_v3': (0 if v4 else 12) * len(imgs),
            'window_attention_v4': (12 if v4 else 0) * len(imgs)}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f'launches {got}, expected {want}')
    return launches, lat, tc


# ------------------------------------------------------------- phase 5
def _copy_model(cpu, dtype, device):
    """A detector of the CPU model's config computing in ``dtype``, with
    its weights, on ``device``: built there, so that its parameters are
    not drawn on the host first only to be overwritten."""
    with torch.device(device):
        model = build_detector(dict(cpu.cfg.model, dtype=dtype))
    model.load_state_dict(cpu.state_dict())
    return model.to(device)


def _spread_heads(model):
    """Scale rpn_cls and every bbox head's fc_cls to std 1, so no top-k or
    NMS boundary sits within fp32 noise (the cascade has three)."""
    heads = model.roi_head.bbox_head
    with torch.no_grad():
        model.rpn_head.rpn_cls.weight.mul_(100.0)
        for head in heads if isinstance(heads, torch.nn.ModuleList) \
                else (heads,):
            head.fc_cls.weight.mul_(100.0)


def _draw_roi_plugins(model, seed=4):
    """Draw each RoI extractor's GeneralizedAttention ``gamma`` (zero at
    init, which makes the attention the identity and leaves its convs
    without gradient) from a seeded generator, as _draw_plugins draws a
    backbone's; both sides of a check load the drawn CPU model."""
    from swindet_tpu_torch.ops.plugins import GeneralizedAttention
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.roi_head.modules():
            if isinstance(m, GeneralizedAttention):
                m.gamma.copy_(torch.randn(1, generator=gen))


def _serve_errors(cpu_out, out):
    """FPN features' relative max |d|, and None where the detections or
    labels differ, else (box, mask max |d|, detections); the mask |d| is
    the larger of the mask probabilities' and Mask Scoring R-CNN's mask
    scores', 0 for a detector without masks."""
    (f_cpu, o_cpu), (f_gpu, o_gpu) = cpu_out, out
    feat_err = max((a - b).abs().max().item() / max(a.abs().max().item(), 1)
                   for a, b in zip(f_cpu, f_gpu))
    if not torch.equal(o_cpu['det_valid'], o_gpu['det_valid']) \
            or not torch.equal(o_cpu['labels'], o_gpu['labels']):
        return feat_err, None
    mask_err = max(((o_cpu[k] - o_gpu[k]).abs().max().item()
                    for k in ('mask_probs', 'mask_scores') if k in o_cpu),
                   default=0.0)
    return feat_err, ((o_cpu['dets'] - o_gpu['dets']).abs().max().item(),
                      mask_err, int(o_cpu['det_valid'].sum()))


def _serve_outputs(model, dev, img, shapes, sf):
    args = [torch.from_numpy(a).to(dev) for a in (img, shapes, sf)]
    with torch.inference_mode():
        feats = model.extract_feat(args[0])
        out = model.simple_test(*args)
    return ([f.cpu().float() for f in feats],
            {k: v.cpu() for k, v in out.items()})


def phase_check(device: str = 'cuda', phase: str = 'check',
                fused: bool = False, v4: bool = False, config=CONFIG,
                control: bool = False, cfg_options=None):
    """fp32 Mask R-CNN (``config``) on a 224x320 canvas, on the card
    (kernels) and on the CPU (plain versions), same seeded weights; rpn_cls
    and fc_cls are scaled to std 1 so no top-k or NMS boundary sits within
    fp32 noise, and a RoI extractor's attention is drawn
    (_draw_roi_plugins). With ``control``, the same detector in bf16 on
    the card, held to the same CPU run, must exceed the limits.
    ``cfg_options``: further config options of the three runs (the
    cascade's cut depths)."""
    opts = {'bf16': False, 'model.test_cfg.rpn.nms_pre': 1000,
            'model.test_cfg.rpn.max_per_img': 1000, **(cfg_options or {})}
    cpu = init_detector(config, device='cpu', cfg_options=opts, seed=1)
    _spread_heads(cpu)
    _draw_roi_plugins(cpu)
    rs = np.random.RandomState(1)
    img = rs.randn(1, 224, 320, 3).astype(np.float32)
    shapes = np.array([[224, 320]], np.int32)
    sf = np.ones((1, 4), np.float32)
    gpu = _copy_model(cpu, 'float32', device)
    gpu = gpu.to(device).eval()
    _check_blocks(gpu, fused, v4)
    reset_launch_counts()
    want = _serve_outputs(cpu, 'cpu', img, shapes, sf)
    got = _serve_outputs(gpu, device, img, shapes, sf)
    # a CNN backbone (phase 20's HTC) runs no attention kernel
    swin = any(isinstance(m, WindowAttention) for m in gpu.modules())
    if device == 'cuda' and swin and (
            bool(fused_mlp.launches) != fused
            or bool(window_attention_v4.launches) != v4
            or bool(window_attention_v3.launches) == v4):
        raise AssertionError(f'launches against the configuration: '
                             f'{launch_counts()}')
    if device == 'cuda':
        _check_tc(phase, launch_counts(), False,
                  _tc_kernels(fused, False, v4) if swin else (conv3x3,))
    feat_err, errs = _serve_errors(want, got)
    if errs is None:
        raise AssertionError('detections differ between card and CPU')
    box_err, mask_err, n = errs
    if feat_err > 1e-3 or n == 0 or box_err > 1e-2 or mask_err > 1e-3:
        raise AssertionError(f'FPN features rel max|d| {feat_err:.3g} '
                             f'(1e-3), {n} dets, box max|d| {box_err:.3g} '
                             f'(1e-2), mask max|d| {mask_err:.3g} (1e-3)')
    log(phase, f'224x320 fp32 card vs CPU: features rel max|d| '
                 f'{feat_err:.3g}, {n} dets equal, box max|d| '
                 f'{box_err:.3g} px, mask max|d| {mask_err:.3g}')
    if not control:
        return
    ctl = _copy_model(cpu, 'bfloat16', device)
    feat_err, errs = _serve_errors(want, _serve_outputs(
        ctl.to(device).eval(), device, img, shapes, sf))
    log(phase, f'bf16 control vs the fp32 CPU run: features rel max|d| '
               f'{feat_err:.3g}, detections '
               + ('differ' if errs is None else
                  f'equal, box max|d| {errs[0]:.3g}, mask max|d| '
                  f'{errs[1]:.3g}'))
    if errs is not None and feat_err <= 1e-3 and errs[0] <= 1e-2 \
            and errs[1] <= 1e-3:
        raise AssertionError('the bf16 control passes the fp32 limits')


# ------------------------------------------------------------- phase 6
TRAIN_GRADS = (
    'backbone.patch_embed.proj.weight',
    'backbone.layers.0.blocks.0.attn.qkv.weight',
    'backbone.layers.0.blocks.0.attn.relative_position_bias_table',
    'neck.fpn_convs.0.conv.weight',
    'rpn_head.rpn_conv.weight',
    'roi_head.bbox_head.fc_cls.weight',
    'roi_head.mask_head.convs.0.conv.weight',
)


def synthetic_train_batch(n=2, seed=0, canvas=(800, 1344)):
    """The keys of make_train_step's batch on the card: n synthetic
    800x1333 images (normalized, RGB, padded onto ``canvas``) whose 16
    painted rectangles are the ground truth -- boxes, bitmap masks and
    seeded labels."""
    imgs, rects = synthetic_images(n, seed=seed, with_boxes=True)
    h, w = imgs[0].shape[:2]
    rs = np.random.RandomState(seed + 100)
    img = np.zeros((n, *canvas, 3), np.float32)
    masks = np.zeros((n, 16, *canvas), np.uint8)
    for i, (raw, boxes) in enumerate(zip(imgs, rects)):
        img[i, :h, :w] = (raw[..., ::-1] - IMG_MEAN) / IMG_STD
        for j, (x1, y1, x2, y2) in enumerate(boxes.astype(int)):
            masks[i, j, y1:y2, x1:x2] = 1
    batch = dict(img=img, img_shapes=np.array([[h, w]] * n, np.int32),
                 pad_shapes=np.array([canvas] * n, np.int32),
                 gt_bboxes=np.stack(rects), gt_valid=np.ones((n, 16), bool),
                 gt_labels=rs.randint(0, 80, (n, 16)), gt_masks=masks)
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _check_log(log, what):
    bad = {k: v for k, v in log.items() if not np.isfinite(v)}
    if bad:
        raise AssertionError(f'{what}: non-finite {bad}')


def _profile_steps(step, batch, gen, step_ms, phase, n=2, rows_out=None):
    """Device time by kernel over ``n`` more steps (torch.profiler), per
    step, and the card's busy share of an unprofiled step (``step_ms``,
    the median of the timed steps), which it returns: the profiler slows
    the host, not the kernels. ``rows_out``, a list, receives each
    kernel's (name, ms a step, launches a step)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            _check_log(step(batch, gen), 'profiled step')
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)
            and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    if rows_out is not None:
        rows_out.extend(rows)
    busy = sum(r[1] for r in rows)
    log(phase, f'profile: {busy:.1f} ms of kernel time per step, '
                 f'{len(rows)} kernels; against the {step_ms:.1f} ms '
                 f'median unprofiled step the card is busy '
                 f'{busy / step_ms:.3f} of the time')
    # one stream runs one kernel at a time: a share over 1 would mean
    # device time counted twice
    if busy > step_ms:
        raise AssertionError(f'profiled kernel time {busy:.1f} ms exceeds '
                             f'the {step_ms:.1f} ms step')
    ours = [r for r in rows if 'swindet' in r[0]]
    log(phase, f'  hand-written kernels: '
                 f'{sum(r[1] for r in ours):.1f} ms per step, of which the '
                 f'fused MLP\'s '
                 f'{sum(r[1] for r in ours if "mlp" in r[0]):.2f} ms')
    for key, ms, count in ours + [r for r in rows if r not in ours][:12]:
        log(phase, f'  {ms:9.3f} ms/step  {count:5d} launches/step  '
                     f'{key[:110]}')
    return busy / step_ms


@contextlib.contextmanager
def nms_without_host_reads():
    """Run the RPN's batched_nms (the NMS of the training step) under
    torch.cuda.set_sync_debug_mode('error'): a host read or a synchronising
    copy inside it raises. Yields the list of its calls."""
    batched_nms = rpn_head_module.batched_nms
    calls = []

    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode('error')
        try:
            calls.append(batched_nms(*args, **kw))
        finally:
            torch.cuda.set_sync_debug_mode('default')
        return calls[-1]
    rpn_head_module.batched_nms = strict
    try:
        yield calls
    finally:
        rpn_head_module.batched_nms = batched_nms


def phase_train(phase='train', fused=False, v4=False):
    """Full-width Mask R-CNN Swin-T training steps in bf16 on the card."""
    cfg = Config.fromfile(CONFIG)
    model = init_detector(cfg, device='cuda', seed=0)
    opt = build_optimizer(model, dict(cfg.optimizer))
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH)
    step = make_train_step(model, opt, schedule,
                           dict(cfg.optimizer_config).get('grad_clip'))
    blocks, v4_blocks = _check_blocks(model, fused, v4)
    log(phase, f'{type(model).__name__} compute {model.dtype}, '
               f'drop_path_rate {cfg.model.backbone.drop_path_rate}, '
               f'{blocks} fused token MLPs, {v4_blocks} v4 attention blocks, '
               f'{cfg.optimizer["type"]} groups '
               f'{[(g["weight_decay"], len(g["params"])) for g in opt.param_groups]}')
    batch = synthetic_train_batch()
    gen = torch.Generator(device='cuda').manual_seed(0)
    before = [p.detach().clone() for p in model.parameters()]
    t0 = time.perf_counter()
    _check_log(step(batch, gen), 'warm-up step')
    torch.cuda.synchronize()
    log(phase, f'warm-up step {time.perf_counter() - t0:.3f} s')

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_log(out, 'timed step')
    steps = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(phase, 'per-step ms: ' + ', '.join(f'{t:.1f}' for t in times)
               + f'; peak memory {peak / 2 ** 30:.2f} GiB')
    log(phase, 'last step: ' + ', '.join(f'{k} {v:.4f}'
                                         for k, v in out.items()))
    log(phase, f'kernel launches over the 5 timed steps: {steps}')
    tc = _check_tc(phase, steps, True, _tc_kernels(fused, v4=v4))
    log(phase, f'of which tensor-core kernels: {tc}')
    # with a gradient wanted the attention forward is the softmax-saving
    # kernel, never the inference one, or in the v4 configuration the v4
    # forward and backward in place of all three; every other kernel of
    # the configuration runs
    v3_training = (window_attention_fwd_p, window_attention_bwd)
    idle = [fn.__name__ for fn in KERNEL_WRAPPERS
            if fn is not window_attention_v3 and fn not in OP_ONLY_KERNELS
            and steps[fn.__name__] == 0
            and (fused or fn not in FUSED_MLP_KERNELS)
            and (fn not in (v3_training if v4 else WATTN_V4_KERNELS))]
    if idle:
        raise AssertionError(f'kernels not launched in training: {idle}')
    # NMS once a step (the RPN proposals); the fused forward and backward
    # once per fused block; the attention forward and backward once per
    # Swin block
    attn = 0 if v4 else 60
    want = {'nms_sorted': 5, 'fused_mlp': 50 if fused else 0,
            'fused_mlp_bwd': 50 if fused else 0, 'window_attention_v3': 0,
            'window_attention_fwd_p': attn, 'window_attention_bwd': attn,
            'window_attention_v4': 60 - attn,
            'window_attention_v4_bwd': 60 - attn,
            'window_attention': 0, 'swin_window_attention': 0}
    got = {k: steps[k] for k in want}
    if got != want:
        raise AssertionError(f'launches {got}, expected {want}')
    still = sum(torch.equal(a, p.detach())
                for a, p in zip(before, model.parameters()))
    if still:
        raise AssertionError(f'{still} parameter tensors did not change')
    del before
    with nms_without_host_reads() as calls:
        _check_log(step(batch, gen), 'step without host reads in NMS')
    if len(calls) != 1:
        raise AssertionError(f'{len(calls)} NMS calls in a step')
    log(phase, "one more step with its NMS under torch.cuda."
               "set_sync_debug_mode('error'): no host read")
    # a validation pass of the trained model, counted on its own: eval
    # mode must go back to the inference kernels
    reset_launch_counts()
    with torch.inference_mode():
        model.eval()
        res = model.simple_test(batch['img'], batch['img_shapes'],
                                torch.ones((2, 4), device='cuda'))
        model.train()
    if not torch.isfinite(res['dets']).all():
        raise AssertionError('validation pass: non-finite detections')
    val = launch_counts()
    log(phase, f'kernel launches of one validation pass (simple_test on '
               f'the batch): {val}')
    wrong = [fn.__name__ for fn in _serving_kernels(v4)
             if val[fn.__name__] == 0] + [
        fn.__name__ for fn in NOT_SERVING if val[fn.__name__]]
    if wrong:
        raise AssertionError(f'validation pass: kernels idle or launched '
                             f'against their mode: {wrong}')
    _check_tc('validation pass', val, True,
              _tc_kernels(fused, False, v4))
    busy = _profile_steps(step, batch, gen, float(np.median(times)), phase)
    return steps, times, peak, busy, tc


# ------------------------------------------------------------- phase 7
def train_check_batch(b=2, h=224, w=320, g=4, seed=2):
    """Gt boxes at fractional coordinates with filled-ellipse masks, so no
    mask-target sample sits on the 0.5 threshold."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] + 0.5
    boxes = np.zeros((b, g, 4), np.float32)
    masks = np.zeros((b, g, h, w), np.uint8)
    for i in range(b):
        cx, cy = rs.uniform(0.2, 0.8, g) * w, rs.uniform(0.2, 0.8, g) * h
        bw, bh = rs.uniform(24, 120, g), rs.uniform(24, 100, g)
        boxes[i] = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                             cy + bh / 2], -1)
        for j in range(g):
            masks[i, j] = (((xx - cx[j]) / (bw[j] / 2)) ** 2
                           + ((yy - cy[j]) / (bh[j] / 2)) ** 2) <= 1
    return dict(img=rs.randn(b, h, w, 3).astype(np.float32),
                img_shapes=np.array([[h, w]] * b, np.int32),
                pad_shapes=np.array([[h, w]] * b, np.int32),
                gt_bboxes=boxes, gt_valid=np.ones((b, g), bool),
                gt_labels=rs.randint(0, 80, (b, g)), gt_masks=masks)


# the groups of loss terms whose gradients the check holds apart, by the
# terms' names (a cascade's are 's0.loss_cls' and so on)
LOSS_PARTS = {'rpn': ('loss_rpn_cls', 'loss_rpn_bbox'),
              'bbox': ('loss_cls', 'loss_bbox'), 'mask': ('loss_mask',),
              'semantic': ('loss_semantic_seg',),
              'mask_iou': ('loss_mask_iou',)}


def _part_terms(losses, part):
    """The loss terms of ``losses`` in a group of LOSS_PARTS: a term whose
    name ends with one of the group's names."""
    return [k for k in losses
            if any(k.split('.')[-1] == t for t in LOSS_PARTS[part])]
# Limits of the fp32 card-vs-CPU training check, each between the sound
# run's reading and a bf16 control run's (H100, 224x320): the losses read
# at most 2.0e-7 relative (fp32 sums in another order; the forward kernels
# are deterministic), the control at least 2.0e-5. Gradients, as max |d|
# over the largest entry, for each group of loss terms on its own. The
# RPN group reads at most 2.4e-6 (control 3.2e-2 and up). The bbox and
# mask groups read up to 1.8e-3 (control 2.1e-2 and up): a few ReLU units
# of the RoI heads (2 of the bbox head's 2.1M, 60 of the mask head's 51M)
# sit within fp32 rounding of zero and pass their gradient on one side
# only, and every positive roi's units carry gradient. The RPN conv has 3
# such units too, but its losses send gradient only to the pixels of the
# 256 anchors sampled per image.
TOL_TRAIN_LOSS = 2e-6
# The rois a training check samples an image where a config samples 512:
# its CPU side runs the RoI heads' backward, the plain RoIAlign backward
# most of it, on every sampled roi (phase 12's note below): the checks
# of phases 7, 10, 12, 15, 16, 20 and 21
CHECK_ROIS = 128
# HTC's semantic loss (phase 20) takes the bbox and mask groups' limit: its
# gradient passes back through the semantic head's ReLU convs over whole
# maps, as theirs through the RoI heads' (set before its first card run)
# Mask Scoring R-CNN's MaskIoU loss (phase 21) takes it too: its gradient
# passes back through the MaskIoU head's ReLU convs and fcs into the mask
# head's (set before its first card run)
TOL_TRAIN_GRAD = {'rpn': 1e-4, 'bbox': 6e-3, 'mask': 6e-3, 'semantic': 6e-3,
                  'mask_iou': 6e-3}
# The portrait check's proposal chain: the card's RPN scores and deltas
# against the CPU's, max |d| over the largest entry (fp32 sums in another
# order; the bf16 control reads 1e-3 and more); and the card's proposal
# step against the plain one on the same RPN outputs, boxes in px (the
# decode's exp and products in another order).
TOL_RPN_OUT = 2e-5
TOL_PROPOSAL_PX = 1e-3
# The card's unpinned proposals against the CPU run's, slot order aside:
# noise can trade a few near-tied proposals at the top-k and NMS
# boundaries (the card read all 2,000 matched); a fault in the RPN head,
# the decode or NMS moves far more.
MIN_PROPOSAL_SHARE = 0.99


def _heads(part):
    """A RoI head's bbox or mask heads as a list (a cascade has one a
    stage; a bbox-only RoI head has no mask head)."""
    if part is None:
        return []
    return list(part) if isinstance(part, torch.nn.ModuleList) else [part]


def _backbone_relus(model, seen):
    """Forward hooks that append to ``seen`` which units each ReLU of a
    ResNet backbone lets through (a block's bn1 and, in a bottleneck, bn2
    before their ReLU, and the block's output after its own); none for a
    backbone without such blocks (Swin's GELUs)."""
    from swindet_tpu_torch.models.backbones.resnet import (BasicBlock,
                                                           Bottleneck)

    def keep(mod, args, out):
        seen.append((out > 0).flatten().cpu())
    hooks = []
    for m in model.backbone.modules():
        if isinstance(m, (BasicBlock, Bottleneck)):
            parts = (m, getattr(m, m.norm1_name)) + (
                (getattr(m, m.norm2_name),) if isinstance(m, Bottleneck)
                else ())
            hooks += [p.register_forward_hook(keep) for p in parts]
    return hooks


def _record(model):
    """Keep, to count where two runs of forward_train differ, the bbox
    labels and mask targets that the RoI heads compute and which units
    each ReLU of the heads lets through: the RPN conv's, the bbox heads'
    shared convs' and fcs' and the mask heads' convs', and a ResNet
    backbone's. Returns what it keeps and a function that undoes the
    recording."""
    seen = {k: [] for k in ('labels', 'mask_targets', 'relu_rpn',
                            'relu_bbox', 'relu_mask', 'relu_backbone')}
    bbox_heads = _heads(model.roi_head.bbox_head)
    mask_heads = _heads(model.roi_head.mask_head)
    for key, heads in (('labels', bbox_heads), ('mask_targets', mask_heads)):
        for head in heads:
            def record(*args, _fn=head.get_targets, _key=key, **kw):
                out = _fn(*args, **kw)
                seen[_key].append((out[0] if isinstance(out, tuple)
                                   else out).detach().cpu())
                return out
            head.get_targets = record

    def keep(key):
        return lambda mod, args, out: seen[key].append(
            (out > 0).flatten().cpu())
    hooks = [m.register_forward_hook(keep('relu_bbox')) for h in bbox_heads
             for m in list(h.shared_convs) + list(h.shared_fcs)]
    hooks += [m.register_forward_hook(keep('relu_mask')) for h in mask_heads
              for m in h.convs]
    hooks += _backbone_relus(model, seen['relu_backbone'])
    conv_nhwc = rpn_head_module.conv_nhwc

    def rpn_conv(x, conv, relu, *args):
        out = conv_nhwc(x, conv, relu, *args)
        if relu:
            seen['relu_rpn'].append((out > 0).flatten().cpu())
        return out
    rpn_head_module.conv_nhwc = rpn_conv

    def undo():
        for h in hooks:
            h.remove()
        rpn_head_module.conv_nhwc = conv_nhwc
        for head in bbox_heads + mask_heads:
            del head.get_targets
    return seen, undo


def _to(keys, dev):
    """Sampler keys (nested lists of numpy pairs) as tensors on ``dev``."""
    if isinstance(keys, np.ndarray):
        return torch.from_numpy(keys).to(dev)
    if isinstance(keys, dict):
        return {k: _to(v, dev) for k, v in keys.items()}
    return type(keys)(_to(v, dev) for v in keys)


def _train_grads(model, batch, keys, dev, names=TRAIN_GRADS):
    """forward_train on ``dev``: its losses, the gradients of ``names``
    from each group of LOSS_PARTS on its own (zeros where a group does not
    reach a parameter), and what :func:`_record` keeps."""
    seen, undo = _record(model)
    model.train()
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    seg = {} if 'gt_semantic_seg' not in tb \
        else dict(gt_semantic_seg=tb['gt_semantic_seg'])
    try:
        losses = model.forward_train(
            tb['img'], tb['img_shapes'], tb['pad_shapes'], tb['gt_bboxes'],
            tb['gt_valid'], tb['gt_labels'], tb['gt_masks'],
            sampler_keys=_to(keys, dev), **seg)
    finally:
        undo()
    params = dict(model.named_parameters())
    ps = [params[n] for n in names]
    grads = {}
    # the groups the model has (a Faster R-CNN has no mask loss)
    parts = [p for p in LOSS_PARTS if _part_terms(losses, p)]
    for i, part in enumerate(parts):
        gs = torch.autograd.grad(sum(losses[k] for k in _part_terms(
            losses, part)), ps, retain_graph=i + 1 < len(parts),
            allow_unused=True)
        grads[part] = {n: (torch.zeros_like(p) if g is None else g)
                       .detach().cpu() for n, p, g in zip(names, ps, gs)}
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            {k: torch.cat(v) if v else torch.zeros(0, dtype=torch.bool)
             for k, v in seen.items()})


def _train_errors(want, got):
    """Relative loss |d| per loss term; per part and parameter the
    gradient's max |d| over its largest entry (None where the part does
    not reach the parameter); and the targets and ReLU units that
    differ."""
    (l_w, g_w, t_w), (l_g, g_g, t_g) = want, got
    loss = {k: abs(l_g[k] - v) / max(abs(v), 1e-30) for k, v in l_w.items()}
    grad = {part: {n: None if not g.abs().max() else
                   ((g_g[part][n] - g).abs().max() / g.abs().max()).item()
                   for n, g in g_w[part].items()} for part in g_w}
    flips = {k: int((t_g[k] != t_w[k]).sum()) for k in t_w}
    return loss, grad, flips


def _log_errors(what, loss, grad, flips):
    log('train-check', f'{what}: relative loss |d| '
        + ', '.join(f'{k} {v:.3g}' for k, v in loss.items())
        + f'; targets and ReLU units that differ {flips}')
    for n in grad['rpn']:
        log('train-check', f'  grad |d| / max {n}: ' + ', '.join(
            f'{part} ' + ('-' if grad[part][n] is None
                          else f'{grad[part][n]:.3g}') for part in grad))


def _check_train(loss, grad, what, limits=None):
    """The names of the readings over their limits: TOL_TRAIN_*, or
    ``limits`` = (loss limits by term, where they differ; gradient limits
    by part, or by parameter name where a parameter has its own)."""
    tol_loss, tol_grad = limits or ({}, TOL_TRAIN_GRAD)
    over = [k for k, v in loss.items()
            if not v <= tol_loss.get(k, TOL_TRAIN_LOSS)]
    for part, errs in grad.items():
        over += [f'grad {n} of the {part} losses' for n, v in errs.items()
                 if v is not None
                 and not v <= tol_grad.get(n, tol_grad[part])]
    log('train-check', f'{what}: {len(over)} readings over their limits')
    return over


@contextlib.contextmanager
def rpn_outputs(model, reference=None):
    """Record, in the list it yields, the RPN class scores and box deltas
    that ``model``'s RPN head gives its proposal step, on the CPU; with
    ``reference`` (such a list) the step reads those in place of the
    model's own, on its device."""
    get = model.rpn_head.get_proposals
    seen = []

    def step(cls_scores, bbox_preds, *args, **kw):
        seen.append(([t.cpu() for t in cls_scores],
                     [t.cpu() for t in bbox_preds]))
        if reference is not None:
            dev = cls_scores[0].device
            cls_scores, bbox_preds = ([t.to(dev) for t in ts]
                                      for ts in reference[0])
        return get(cls_scores, bbox_preds, *args, **kw)
    model.rpn_head.get_proposals = step
    try:
        yield seen
    finally:
        del model.rpn_head.get_proposals


def _rpn_error(want, got):
    """Max |d| of the RPN class scores and of the box deltas, each over
    its largest entry in ``want`` ((scores, deltas) per level)."""
    return tuple(max(float((g.float() - w).abs().max()) for w, g in
                     zip(ws, gs)) / max(float(w.abs().max()) for w in ws)
                 for ws, gs in zip(want, got))


def check_proposal_chain(cpu, gpu, batch, own, device):
    """The card's proposal step (box decode, top-k, NMS kernel) on the
    card's own RPN outputs ``own``, held to the plain step on the CPU on
    the same outputs: equal validity and scores, boxes within
    TOL_PROPOSAL_PX. Returns the card's proposals, on the CPU."""
    cfg = dict(cpu.train_cfg.get('rpn_proposal',
                                 dict(cpu.test_cfg)['rpn']))
    shapes = torch.from_numpy(batch['img_shapes'])
    with torch.no_grad():
        got = gpu.rpn_head.get_proposals(
            *([t.to(device) for t in ts] for ts in own), shapes.to(device),
            cfg)
        want = cpu.rpn_head.get_proposals(*own, shapes, cfg)
    got = [t.cpu() for t in got]
    if not torch.equal(got[2], want[2]):
        raise AssertionError('the card\'s proposal validity differs from '
                             'the plain step\'s on the same RPN outputs')
    ok = want[2]
    d_box = float((got[0] - want[0]).abs()[ok].max())
    d_score = float((got[1] - want[1]).abs()[ok].max())
    swapped = _swapped_slots(want, got, ok) if d_box > TOL_PROPOSAL_PX \
        else 0
    log('train-check', f'proposal step on the card\'s RPN outputs: card vs '
                       f'plain, {int(ok.sum())} valid, boxes max |d| '
                       f'{d_box:.3g} px, scores max |d| {d_score:.3g}; '
                       f'slots of near-tied scores swapped: {swapped}')
    if swapped is None or not d_score <= 1e-6:
        raise AssertionError('the card\'s proposal step departs from the '
                             'plain one on the same RPN outputs')
    return got


def _swapped_slots(want, got, ok, tol_score=1e-6):
    """The count of the card's proposal slots whose box is not the plain
    step's in the same slot, where those boxes are the plain step's of
    the same slots in another order: the sigmoid of the card and of the
    CPU may round one ulp apart, and two scores that close (ResNeSt's
    seeded RPN has hundreds of pairs in its top 2,000) may sort either
    way. Each such card slot must take a distinct one of those plain
    boxes, within TOL_PROPOSAL_PX and with a score within ``tol_score``
    of its own (a one-to-one match, so a plain box lost and another
    doubled does not pass). None where no such match exists."""
    swapped = 0
    for i in range(ok.shape[0]):
        v = ok[i]
        wb, ws, gb, gs = want[0][i][v], want[1][i][v], got[0][i][v], \
            got[1][i][v]
        moved = torch.nonzero(
            (gb - wb).abs().amax(-1) > TOL_PROPOSAL_PX).flatten()
        if not len(moved):
            continue
        # fits[k, j]: card slot moved[k] may hold plain slot moved[j]'s box
        fits = ((gb[moved][:, None] - wb[moved][None]).abs().amax(-1)
                <= TOL_PROPOSAL_PX) \
            & ((gs[moved][:, None] - ws[moved][None]).abs() <= tol_score)
        if _max_matching(fits) < len(moved):
            return None
        swapped += len(moved)
    return swapped


def _max_matching(fits):
    """The size of a largest one-to-one matching of rows to columns of
    the boolean matrix ``fits`` (augmenting paths, searched without
    recursion)."""
    edges = [torch.nonzero(r).flatten().tolist() for r in fits]
    owner = [-1] * fits.shape[1]
    size = 0
    for root in range(len(edges)):
        # depth-first search for a free column, rows reached through the
        # columns they own; parent[c] is the row that reached column c
        parent = {}
        stack = [(root, iter(edges[root]))]
        free = None
        while stack and free is None:
            row, todo = stack[-1]
            for c in todo:
                if c in parent:
                    continue
                parent[c] = row
                if owner[c] < 0:
                    free = c
                else:
                    stack.append((owner[c], iter(edges[owner[c]])))
                break
            else:
                stack.pop()
        if free is None:
            continue
        c = free
        while c is not None:
            row = parent[c]
            prev = next((p for p, r in enumerate(owner) if r == row), None)
            owner[c] = row
            c = prev
        size += 1
    return size


def _matched_share(want, got):
    """Share of ``want``'s valid proposals with a valid proposal of ``got``
    in the same image within TOL_PROPOSAL_PX on every coordinate."""
    hit = total = 0
    for wb, wv, gb, gv in zip(want[0], want[2], got[0], got[2]):
        d = (wb[wv][:, None] - gb[gv][None]).abs().amax(-1)
        hit += int((d.amin(1) <= TOL_PROPOSAL_PX).sum())
        total += int(wv.sum())
    return hit / total


def phase_train_check(device: str = 'cuda', fused: bool = False,
                      v4: bool = False, batch=None,
                      pin_proposals: bool = False, config=CONFIG,
                      names=TRAIN_GRADS, limits=None,
                      opts=(('bf16', False),
                            ('model.backbone.drop_path_rate', 0.0),
                            ('model.train_cfg.rcnn.sampler.num',
                             CHECK_ROIS)),
                      rpn_tol=TOL_RPN_OUT, min_share=MIN_PROPOSAL_SHARE,
                      cpu=None):
    """forward_train of the full-width detector (``config``) in fp32 on a
    224x320 canvas (or on ``batch``), on the card (kernels) and on the CPU
    (plain versions): same
    seeded weights with rpn_cls and fc_cls scaled to std 1 (no top-k, NMS
    or IoU boundary within fp32 noise), same batch, same sampler keys
    (a cascade's per stage), no stochastic depth. The losses and the
    gradients of ``names`` of each group of loss terms must agree within
    TOL_TRAIN_* (or ``limits``, as _check_train takes them). A control
    run of
    the same detector in bf16 on the card, held to the same CPU run, must
    exceed the loss limit and each group's gradient limit: the check
    tells a card run that lost precision from a sound one.

    ``pin_proposals``: for the losses and gradients, the card runs'
    proposal steps read the CPU run's RPN scores and box deltas. On a
    canvas of real images the card's own proposals are the CPU run's set
    in another slot order (fp32 noise reorders near-tied scores), and
    the samplers' keys go by slot. So the chain is checked apart,
    unpinned: the card's own RPN outputs against the CPU's (TOL_RPN_OUT,
    which the bf16 control must exceed), the card's proposal step on
    them against the plain step (check_proposal_chain), and the card's
    own proposals against the CPU run's as sets (MIN_PROPOSAL_SHARE).
    ``opts``: the config options of the three runs (a ResNet has no
    stochastic depth to turn off; the default samples CHECK_ROIS rois an
    image). ``rpn_tol`` and ``min_share``: the
    limits of the RPN outputs and of the share of proposals matched.
    ``cpu``: the CPU model of a serving check of the same config, seed and
    options (its heads already spread), used as it is instead of a new
    one."""
    opts = dict(opts)
    start = time.perf_counter()
    if cpu is None:
        cpu = init_detector(config, device='cpu', cfg_options=opts, seed=1)
        _spread_heads(cpu)
    gpu = _copy_model(cpu, 'float32', device)
    gpu = gpu.to(device)
    ctl = _copy_model(cpu, 'bfloat16', device)
    ctl = ctl.to(device)
    _check_blocks(gpu, fused, v4)
    _check_blocks(ctl, fused, v4)
    batch = train_check_batch() if batch is None else batch
    b, h, w = batch['img'].shape[:3]
    g = batch['gt_bboxes'].shape[1]
    # the anchors the RPN's sampler draws keys for: as many a level as
    # the model's own features of this canvas have pixels
    cpu.eval()
    with torch.no_grad():
        feats = cpu.extract_feat(torch.from_numpy(batch['img'][:1]))
    n_rpn = sum(a * f.shape[1] * f.shape[2] for a, f in zip(
        cpu.rpn_head.prior_generator.num_base_anchors, feats))
    rcnn = cpu.cfg.model.train_cfg.rcnn
    n_props = cpu.cfg.model.train_cfg.rpn_proposal.max_per_img
    rs = np.random.RandomState(7)

    def draw(n):
        return [tuple(rs.rand(n).astype(np.float32) for _ in range(2))
                for _ in range(b)]
    keys = dict(rpn=draw(n_rpn))
    if isinstance(rcnn, (list, tuple)):
        # a cascade's stages: G + P candidates, then G + num; an HTC's
        # interleaved mask branch samples again after each stage's bbox
        # sample, over the G + num boxes that stage refined
        resample = getattr(cpu.roi_head, 'interleaved', False) \
            and cpu.roi_head.with_mask
        keys['rcnn'] = []
        cand = g + n_props
        for stage in rcnn:
            keys['rcnn'].append(draw(cand))
            cand = g + stage['sampler']['num']
            if resample:
                keys['rcnn'].append(draw(cand))
    else:
        keys['rcnn'] = draw(g + n_props)

    def pin(model, reference=None):
        return rpn_outputs(model, reference) if pin_proposals \
            else contextlib.nullcontext()
    t0 = time.perf_counter()
    with pin(cpu) as seen:
        ref = _train_grads(cpu, batch, keys, 'cpu', names)
    log('train-check', f'models built in {t0 - start:.1f} s; the CPU run '
                       f'{time.perf_counter() - t0:.1f} s')
    reset_launch_counts()
    with pin(gpu, seen) as own:
        sound = _train_errors(ref, _train_grads(gpu, batch, keys, device,
                                                names))
    if device == 'cuda' and bool(window_attention_v4_bwd.launches) != v4:
        raise AssertionError(f'launches against the configuration: '
                             f'{launch_counts()}')
    if device == 'cuda':
        # a CNN backbone runs no attention kernel
        swin = any(isinstance(m, WindowAttention) for m in gpu.modules())
        _check_tc('train-check', launch_counts(), False,
                  _tc_kernels(fused, v4=v4) if swin
                  else (conv3x3, conv3x3_dw))
    _log_errors(f'{h}x{w} fp32 card vs CPU', *sound)
    with pin(ctl, seen) as ctl_own:
        control = _train_errors(ref, _train_grads(ctl, batch, keys, device,
                                                  names))
    _log_errors(f'{h}x{w} control, bf16 card vs fp32 CPU', *control)
    for name in names:
        if all(g[name] is None for g in sound[1].values()):
            raise AssertionError(f'grad {name}: zero on the CPU')
    over = _check_train(*sound[:2], 'fp32 card vs CPU', limits)
    if over:
        raise AssertionError(f'card vs CPU over the limits: {over}')
    over = _check_train(*control[:2], 'control', limits)
    missed = [part for part in control[1]
              if not any(f'of the {part} losses' in o for o in over)]
    if missed or not any(k in over for k in control[0] if 'loss' in k):
        raise AssertionError(f'the bf16 control passes the loss limit or '
                             f'the gradient limit of {missed}')
    if pin_proposals:
        err, ctl_err = _rpn_error(seen[0], own[0]), \
            _rpn_error(seen[0], ctl_own[0])
        log('train-check', f'RPN outputs card vs CPU, max |d| over the '
                           f'largest entry: scores {err[0]:.3g}, deltas '
                           f'{err[1]:.3g}; bf16 control {ctl_err[0]:.3g}, '
                           f'{ctl_err[1]:.3g}')
        if not max(err) <= rpn_tol < min(ctl_err):
            raise AssertionError('the RPN outputs are over their limit, or '
                                 'the bf16 control is within it')
        got = check_proposal_chain(cpu, gpu, batch, own[0], device)
        with torch.no_grad():
            want = cpu.rpn_head.get_proposals(
                *seen[0], torch.from_numpy(batch['img_shapes']),
                dict(cpu.train_cfg['rpn_proposal']))
        share = _matched_share(want, got)
        log('train-check', f'unpinned: {share:.4f} of the CPU run\'s '
                           f'proposals within {TOL_PROPOSAL_PX} px of one '
                           f'of the card\'s')
        if not share >= min_share:
            raise AssertionError('the card\'s own proposals depart from '
                                 'the CPU run\'s')


def _run_config(name, **flags):
    """Phases 4-7 in one configuration: serving launches and request
    latencies, training launches, step times, peak memory and busy
    share."""
    phase = '' if not flags else f'{name}-'
    t0 = time.perf_counter()
    serve, lat, serve_tc = phase_main(f'{phase}main', **flags)
    t1 = time.perf_counter()
    phase_check(phase=f'{phase}check', **flags)
    t2 = time.perf_counter()
    train, times, peak, busy, train_tc = phase_train(f'{phase}train',
                                                     **flags)
    t3 = time.perf_counter()
    phase_train_check(**flags)
    log('time', f'{name}: phase 4 {t1 - t0:.1f} s, 5 {t2 - t1:.1f}, 6 '
                f'{t3 - t2:.1f}, 7 {time.perf_counter() - t3:.1f}')
    return dict(serve=serve, lat=lat, train=train, times=times, peak=peak,
                busy=busy, serve_tc=serve_tc, train_tc=train_tc)


# ------------------------------------------------------------- phase 10
def png_bytes(bgr: np.ndarray, filter_type: Optional[int] = None,
              level: int = 1) -> bytes:
    """A BGR uint8 (H, W, 3) image as an 8-bit RGB PNG (a (H, W) one as an
    8-bit grayscale PNG), deflated at zlib ``level``: an encoder for the
    card's machine, which has neither cv2 nor PIL. Every row takes PNG
    filter ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), or
    with None the filter libpng's encoder picks for it: the least sum of
    the filtered bytes read as signed."""
    gray = bgr.ndim == 2
    rgb = np.ascontiguousarray(bgr[..., None] if gray else bgr[..., ::-1]) \
        .astype(np.int16)
    h, w, _ = rgb.shape
    a = np.zeros_like(rgb)          # the left pixel
    a[:, 1:] = rgb[:, :-1]
    b = np.zeros_like(rgb)          # the pixel above
    b[1:] = rgb[:-1]
    c = np.zeros_like(rgb)          # above and to the left
    c[1:, 1:] = rgb[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    preds = (np.zeros_like(rgb), a, b, (a + b) >> 1,
             np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)))
    rows = np.stack([((rgb - pred) & 0xff).astype(np.uint8).reshape(h, -1)
                     for pred in preds])
    if filter_type is None:
        cost = np.abs(rows.astype(np.int8).astype(np.int64)).sum(-1)
        kinds = cost.argmin(0)
    elif 0 <= filter_type <= 4:
        kinds = np.full(h, filter_type)
    else:
        raise ValueError(f'PNG filter type {filter_type}')
    raw = np.concatenate([kinds.astype(np.uint8)[:, None],
                          rows[kinds, np.arange(h)]], 1)

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8,
                                         0 if gray else 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(raw.tobytes(), level))
            + chunk(b'IEND', b''))


def _polygon(rs, cx, cy, r, concave):
    """A simple polygon around (cx, cy) of radius about r at fractional
    coordinates: a five-pointed star when ``concave``, else 3-8 points at
    sorted angles."""
    if concave:
        ang = np.arange(10) * np.pi / 5 + rs.uniform(0, np.pi)
        rad = np.where(np.arange(10) % 2, 0.4 * r, r)
    else:
        k = rs.randint(3, 9)
        ang = np.sort(rs.uniform(0, 2 * np.pi, k))
        rad = rs.uniform(0.6, 1.0, k) * r
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)


def write_synthetic_coco(root: str, sizes, seed: int = 0,
                         class_names=COCO_CLASSES) -> tuple:
    """A COCO-style dataset under ``root``: one PNG per (h, w) of
    ``sizes`` (seeded noise) with 3-8 painted polygons, the first of them
    a concave star, each with its annotation (polygon segmentation, xywh
    box, area, one of ``class_names`` as category). Returns (ann_file,
    img_prefix)."""
    from swindet_tpu_torch.core.masks import poly2mask
    rs = np.random.RandomState(seed)
    img_dir = os.path.join(root, 'images')
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        img = rs.randint(0, 64, (h, w, 3)).astype(np.uint8)
        for j in range(rs.randint(3, 9)):
            r = rs.uniform(0.08, 0.25) * min(h, w)
            cx, cy = rs.uniform(r, w - r), rs.uniform(r, h - r)
            poly = _polygon(rs, cx, cy, r, concave=j == 0)
            mask = poly2mask([poly.ravel().tolist()], h, w)
            img[mask] = rs.randint(64, 256, 3)
            x1, y1 = poly.min(0)
            x2, y2 = poly.max(0)
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1,
                category_id=int(rs.randint(len(class_names))) + 1,
                segmentation=[poly.ravel().round(2).tolist()],
                bbox=[round(float(x1), 2), round(float(y1), 2),
                      round(float(x2 - x1), 2), round(float(y2 - y1), 2)],
                area=float(mask.sum()), iscrowd=0))
        name = f'{i:04d}.png'
        with open(os.path.join(img_dir, name), 'wb') as f:
            f.write(png_bytes(img))
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
    ann_file = os.path.join(root, 'annotations.json')
    with open(ann_file, 'w') as f:
        json.dump(dict(images=images, annotations=anns, categories=[
            dict(id=k + 1, name=n) for k, n in enumerate(class_names)]), f)
    return ann_file, img_dir + os.sep


# the loop phase's dataset: 4 landscape and 4 portrait images, 480-1600 px
LOOP_SIZES = ((480, 640), (600, 1000), (800, 1200), (1200, 1600),
              (640, 480), (1000, 600), (1200, 800), (1600, 1200))
# the loop's seed: in epoch 1 its sampler and pipelines draw landscape and
# portrait batches, and in epoch 2 also a batch on the square canvas (a
# crop turned a sample round)
LOOP_SEED = 2
# the loop's gradient norms stay below this: a seeded Mask R-CNN Swin-T
# reads tens to hundreds (on an H100 the loop 33-38, phase 6's step
# 200-250); a zero patchify bias made every padded patch a zero vector,
# whose LayerNorms scale its gradient by eps ** -0.5 each, and read 1e9
# and more, or inf
LOOP_GRAD_NORM_LIMIT = 1e4
# the portrait card-vs-CPU check's dataset: two portrait images whose
# keep-ratio resize to (320, 224) leaves different pad shapes
PORTRAIT_SIZES = ((230, 150), (250, 130))
PORTRAIT_PIPELINE = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', with_bbox=True, with_mask=True),
    dict(type='Resize', img_scale=(320, 224), keep_ratio=True),
    dict(type='RandomFlip', flip_ratio=0.5),
    dict(type='Normalize', mean=IMG_MEAN.tolist(), std=IMG_STD.tolist(),
         to_rgb=True),
    dict(type='Pad', size_divisor=32),
    dict(type='DefaultFormatBundle'),
    dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels', 'gt_masks'])]


def loop_config(ann_file, img_prefix, work_dir, max_epochs=1,
                seed=LOOP_SEED, config=CONFIG):
    """The flagship config (or ``config``) with data.train pointed at a
    synthetic dataset: 2 images a batch, 2 loader threads, a log line
    every iteration."""
    cfg = Config.fromfile(config)
    cfg.data.train.ann_file = ann_file
    cfg.data.train.img_prefix = img_prefix
    cfg.data.samples_per_gpu = 2
    cfg.data.workers_per_gpu = 2
    cfg.runner.max_epochs = max_epochs
    cfg.log_config.interval = 1
    cfg.work_dir = work_dir
    cfg.seed = seed
    return cfg


def portrait_batch(root):
    """One batch of the port's loader on a 320x224 (H x W) portrait canvas:
    two portrait images with different pad shapes."""
    ann_file, prefix = write_synthetic_coco(root, PORTRAIT_SIZES, seed=3)
    dataset = build_dataset(dict(type='CocoDataset', ann_file=ann_file,
                                 img_prefix=prefix,
                                 pipeline=PORTRAIT_PIPELINE))
    long, short = derive_canvas(PORTRAIT_PIPELINE)
    loader = build_dataloader(dataset, samples_per_gpu=2, workers_per_gpu=1,
                              canvas_long=long, canvas_short=short)
    batch = next(iter(loader))
    batch.pop('img_metas')
    if batch['img'].shape[1:3] != (320, 224) \
            or (batch['pad_shapes'][0] == batch['pad_shapes'][1]).all():
        raise AssertionError(f'portrait batch: canvas '
                             f'{batch["img"].shape[1:3]}, pad shapes '
                             f'{batch["pad_shapes"].tolist()}')
    return batch


def _h2d_ms(batch, iters=5):
    """Device ms of one batch's ``.to('cuda')`` (pageable host memory), by
    CUDA events around ``iters`` copies, and the batch's bytes."""
    host = {k: torch.from_numpy(v) for k, v in batch.items()}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        {k: v.to('cuda') for k, v in host.items()}
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, sum(v.nbytes
                                                for v in batch.values())


def phase_loop(phase='loop'):
    """train_detector from files: Mask R-CNN Swin-T (the flagship config,
    bf16, its own train pipeline with both AutoAugment branches) on a
    synthetic COCO-style dataset of 8 PNGs, 1 epoch of 4 iterations, then
    a second epoch resumed from epoch_1.pth; then the fp32 card-vs-CPU
    training check on a portrait batch of the loader."""
    build_dir = os.path.join(REPO, 'build')
    os.makedirs(build_dir, exist_ok=True)
    start = time.perf_counter()

    def lap(what):
        log(phase, f'{what}: {time.perf_counter() - start:.1f} s into the '
                   f'phase')
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        ann_file, prefix = write_synthetic_coco(root, LOOP_SIZES)
        lap('dataset written')
        work = os.path.join(root, 'work')
        cfg = loop_config(ann_file, prefix, work)
        dataset = build_dataset(cfg.data.train)
        model_cfg = dict(cfg.model, dtype='bfloat16')
        model_cfg.pop('pretrained', None)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        first = train_detector(build_detector(model_cfg), dataset, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        log(phase, f'epoch 1: {len(first.log_vars)} iterations in '
                   f'{wall:.1f} s; kernel launches {launches}')
        lap('epoch 1')
        tc = _check_tc(phase, launches, True, _tc_kernels(False))
        log(phase, f'of which tensor-core kernels: {tc}')
        idle = [fn.__name__ for fn in KERNEL_WRAPPERS
                if fn is not window_attention_v3
                and fn not in OP_ONLY_KERNELS + FUSED_MLP_KERNELS
                + WATTN_V4_KERNELS and not launches[fn.__name__]]
        if idle or launches['window_attention_v3']:
            raise AssertionError(f'kernels not launched in training: {idle}')
        for name in ('epoch_1.pth', 'latest.pth'):
            if not os.path.isfile(os.path.join(work, name)):
                raise AssertionError(f'{name} missing from the work dir')
        cfg = loop_config(ann_file, prefix, work, max_epochs=2)
        cfg.resume_from = os.path.join(work, 'epoch_1.pth')
        # the resumed epoch evaluates on the same PNGs (test mode)
        cfg.data.val.ann_file = ann_file
        cfg.data.val.img_prefix = prefix
        cfg.evaluation = dict(interval=1, metric=['bbox', 'segm'],
                              save_best='auto')
        second = train_detector(build_detector(model_cfg), dataset, cfg,
                                validate=True)
        lap('epoch 2 resumed, with its evaluation')
        runs = (first, second)
        canvases = [c for r in runs for c in r.canvases]
        log(phase, f'canvases (H, W) of the 8 iterations: {canvases}')
        times = {k: [t for r in runs for t in r.times[k]]
                 for k in ('data_time', 'step_time')}
        for k, v in times.items():
            log(phase, f'{k} per iteration (s): '
                       + ', '.join(f'{t:.4f}' for t in v)
                       + f'; median {np.median(v):.4f}')
        for key in ('loss', 'grad_norm'):
            log(phase, f'{key} per iteration: ' + ', '.join(
                f'{v[key]:.4g}' for r in runs for v in r.log_vars))
        peak = torch.cuda.max_memory_allocated()
        log(phase, f'peak device memory {peak / 2 ** 30:.2f} GiB')
        long, short = derive_canvas(cfg.data.train.pipeline)
        loader = build_dataloader(dataset, 2, 1, seed=LOOP_SEED,
                                  canvas_long=long, canvas_short=short)
        t0 = time.perf_counter()
        batch = next(iter(loader))
        log(phase, f'the loader\'s own time for one batch, one thread: '
                   f'{time.perf_counter() - t0:.3f} s')
        batch.pop('img_metas')
        ms, nbytes = _h2d_ms(batch)
        log(phase, f'host-to-device copy of one batch (canvas '
                   f'{batch["img"].shape[1:3]}): {ms:.3f} ms for '
                   f'{nbytes} bytes, of which gt_masks '
                   f'{batch["gt_masks"].nbytes} bytes')
        with open(second.json_log) as f:
            lines = [json.loads(line) for line in f]
        epochs = {r['epoch'] for r in lines}
        if epochs != {2} or second.epoch != 2:
            raise AssertionError(f'the resumed run logged epochs {epochs}')
        val = [r for r in lines if r['mode'] == 'val']
        log(phase, f'epoch 2 evaluation: {val}')
        best = os.path.join(work, 'best_bbox_mAP_epoch_2.pth')
        if len(val) != 1 or not all(
                np.isfinite(v) for k, v in val[0].items() if k != 'mode') \
                or not os.path.isfile(best):
            raise AssertionError(f'the resumed run\'s evaluation: {val}, '
                                 f'best checkpoint {os.path.isfile(best)}')
        bad = [v for r in runs for v in r.log_vars
               if not all(np.isfinite(x) for x in v.values())
               or not v['grad_norm'] < LOOP_GRAD_NORM_LIMIT]
        if bad:
            raise AssertionError(f'non-finite log values or a gradient norm '
                                 f'over {LOOP_GRAD_NORM_LIMIT:g}: {bad}')
        if not {(800, 1344), (1344, 800)} <= set(canvases):
            raise AssertionError('the landscape and portrait canvases did '
                                 'not both run')
        if (1344, 1344) not in canvases:
            log(phase, 'no batch ran on the square canvas')
        check = portrait_batch(os.path.join(root, 'portrait'))
    log(phase, f'portrait batch: canvas {check["img"].shape[1:3]}, pad '
               f'shapes {check["pad_shapes"].tolist()}, image shapes '
               f'{check["img_shapes"].tolist()}')
    lap('loop checked')
    phase_train_check(batch=check, pin_proposals=True)
    lap('portrait check done')


def loop_grad_norms(phase='grad-norms'):
    """Not a phase of main(): each parameter's gradient norm of one loop
    batch (the loader's first, on the 800x1344 canvas) on the card, in
    bf16 and fp32, with the port's seeded init and with its patchify bias
    zeroed (the JAX package's init): the total, the largest element and
    the four largest leaves of each.

        python3 -c "import chip_smoke as cs; cs.phase_build();
                    cs.loop_grad_norms()"
    """
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, 'build')) as root:
        ann_file, prefix = write_synthetic_coco(root, LOOP_SIZES)
        cfg = loop_config(ann_file, prefix, os.path.join(root, 'work'))
        long, short = derive_canvas(cfg.data.train.pipeline)
        loader = build_dataloader(build_dataset(cfg.data.train), 2, 1,
                                  seed=LOOP_SEED, canvas_long=long,
                                  canvas_short=short)
        batch = next(iter(loader))
    batch.pop('img_metas')
    log(phase, f'batch: canvas {batch["img"].shape[1:3]}, image shapes '
               f'{batch["img_shapes"].tolist()}, pad shapes '
               f'{batch["pad_shapes"].tolist()}')
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    for dtype in ('bfloat16', 'float32'):
        for zero_bias in (False, True):
            model_cfg = dict(cfg.model, dtype=dtype)
            model_cfg.pop('pretrained', None)
            model = build_detector(model_cfg)
            model.init_weights(cfg.seed)
            if zero_bias:
                with torch.no_grad():
                    model.backbone.patch_embed.proj.bias.zero_()
            model = model.cuda().train()
            losses = model.forward_train(
                tb['img'], tb['img_shapes'], tb['pad_shapes'],
                tb['gt_bboxes'], tb['gt_valid'], tb['gt_labels'],
                tb['gt_masks'], gen=torch.Generator('cuda').manual_seed(0))
            sum(v.float().sum() for k, v in losses.items()
                if 'loss' in k).backward()
            grads = {n: p.grad.float() for n, p in model.named_parameters()
                     if p.grad is not None}
            norms = {n: float(g.norm()) for n, g in grads.items()}
            top = sorted(norms, key=norms.get, reverse=True)[:4]
            total = float(torch.tensor(list(norms.values())).norm())
            largest = max(float(g.abs().max()) for g in grads.values())
            log(phase, f'{dtype}, {"zero" if zero_bias else "seeded"} '
                       f'patchify bias: total {total:.4g}, largest element '
                       f'{largest:.4g}; '
                       + ', '.join(f'{n} {norms[n]:.4g}' for n in top))
            del model, grads
            torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 11
# the test-time augmentation of phase 11: flip and two scales, 4
# augmentations a batch (full width), and its fp32 check's scales
TTA_SCALES = [(1333, 800), (1333, 640)]
CHECK_SCALES = [(320, 224), (320, 192)]
# card against CPU in fp32 (phase 5's limits): boxes within 1e-2 px,
# pasted masks equal but at pixels whose CPU probability lies within
# 1e-3 of mask_thr_binary, metrics within 1e-4
TOL_EVAL_BOX = 1e-2
TOL_EVAL_PROB = 1e-3
TOL_EVAL_METRIC = 1e-4
# the half-correct case of tests/test_data/test_coco_dataset.py:124: three
# 64x48 images with two 15x15 gts each, the first of each detected
HALF_IMAGES = [dict(id=i, file_name=f'img{i}.jpg', width=64, height=48)
               for i in (1, 2, 3)]
HALF_ANNS = [dict(id=2 * (i - 1) + j + 1, image_id=i, category_id=1,
                  bbox=[5 + 20 * j, 5 + 10 * j, 15, 15], area=225,
                  iscrowd=0,
                  segmentation=[[5 + 20 * j, 5 + 10 * j, 20 + 20 * j,
                                 5 + 10 * j, 20 + 20 * j, 20 + 10 * j,
                                 5 + 20 * j, 20 + 10 * j]])
             for i in (1, 2, 3) for j in (0, 1)]


def eval_config(ann_file, prefix, scales=None, flip=False, config=CONFIG):
    """The flagship config (or ``config``) with data.test pointed at a
    synthetic dataset; with ``scales``, its MultiScaleFlipAug takes them
    and ``flip``."""
    cfg = Config.fromfile(config)
    for part in (cfg.data.test, cfg.data.val):
        part.ann_file = ann_file
        part.img_prefix = prefix
        if scales is not None:
            part.pipeline[1].img_scale = scales
            part.pipeline[1].flip = flip
    return cfg


def _stats(coco, dets, iou_type):
    ev = COCOeval(coco, coco.loadRes(dets), iou_type)
    with contextlib.redirect_stdout(None):
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
    return ev.stats


def eval_checks(root, phase):
    """COCOeval and the host library on this machine: the dataset's own
    ground truth as detections reads 1 for every AP and AR, the
    half-correct case 0.5, and the library's IoU and paste equal their
    numpy versions."""
    ann_file, prefix = write_synthetic_coco(root, LOOP_SIZES)
    ds = build_dataset(dict(eval_config(ann_file, prefix).data.test,
                            test_mode=True))
    results = []
    for i in range(len(ds)):
        anns = ds.coco.loadAnns(ds.coco.getAnnIds(imgIds=[ds.img_ids[i]]))
        bbox = [np.zeros((0, 5), np.float32) for _ in ds.CLASSES]
        segm = [[] for _ in ds.CLASSES]
        for a in anns:
            c = ds.cat2label[a['category_id']]
            x, y, w, h = a['bbox']
            bbox[c] = np.concatenate(
                [bbox[c], np.array([[x, y, x + w, y + h, 1.0]], np.float32)])
            segm[c].append(ds.coco.annToMask(a).astype(bool))
        results.append((bbox, segm))
    bbox_json, segm_json = ds._segm2json(results)
    # AR at 1 detection an image: an image with n gts of a category finds
    # one of them, so a category reads (its images) / (its gts)
    cats = {}
    for a in ds.coco.anns.values():
        imgs, n = cats.get(a['category_id'], (set(), 0))
        cats[a['category_id']] = (imgs | {a['image_id']}, n + 1)
    ar1 = float(np.mean([len(i) / n for i, n in cats.values()]))
    for iou_type, dets in (('bbox', bbox_json), ('segm', segm_json)):
        stats = _stats(ds.coco, dets, iou_type)
        log(phase, f'ground truth as detections, {iou_type}: stats '
                   f'{[round(float(s), 3) for s in stats]} (AR@1 expected '
                   f'{ar1:.3f})')
        rest = np.delete(stats, 6)
        if rest[0] != 1.0 or not all(s in (1.0, -1.0) for s in rest) \
                or abs(stats[6] - ar1) > 1e-12:
            raise AssertionError(f'{iou_type}: ground truth as detections '
                                 f'reads {stats}')
    half_file = os.path.join(root, 'half.json')
    with open(half_file, 'w') as f:
        json.dump(dict(images=HALF_IMAGES, annotations=HALF_ANNS,
                       categories=[dict(id=1, name='person'),
                                   dict(id=2, name='bicycle')]), f)
    half = build_dataset(dict(type='CocoDataset', ann_file=half_file,
                              pipeline=[], classes=('person', 'bicycle'),
                              test_mode=True))
    dets = [[np.array([[5, 5, 20, 20, 1.0]], np.float32),
             np.zeros((0, 5), np.float32)] for _ in range(3)]
    with contextlib.redirect_stdout(None):
        got = half.evaluate(dets, metric='bbox')['bbox_mAP']
    log(phase, f'half-correct case: bbox_mAP {got}')
    if abs(got - 0.5) > 0.01:
        raise AssertionError(f'half-correct case reads {got}, not 0.5')
    # the g++ library against its numpy versions on this machine's build
    rs = np.random.RandomState(11)
    xy = rs.uniform(-40, 700, (100, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(0.5, 400, (100, 2))], 1) \
        .astype(np.float32)
    probs = rs.rand(100, 28, 28).astype(np.float32)
    got = mask_ops.paste_masks(probs, boxes, 600, 1000)
    want = mask_ops.paste_masks_reference(probs, boxes, 600, 1000)
    dts = [mask_ops.mask_to_rle(m) for m in got[:60]]
    gts = [rle.encode(m.astype(np.uint8)) for m in want[60:]]
    if dts != [rle.encode(m.astype(np.uint8)) for m in want[:60]]:
        raise AssertionError('host library RLE differs from numpy')
    crowd = rs.rand(len(gts)) > 0.7
    iou_err = float(np.abs(mask_ops.rle_iou(dts, gts, crowd)
                           - rle.iou(dts, gts, crowd)).max())
    log(phase, f'host library {host_ops.library_path().name}: paste of 100 '
               f'masks at 600x1000 equal to numpy: {np.array_equal(got, want)}'
               f' ({int(got.sum())} pixels); RLE equal; IoU max|d| {iou_err}')
    if not np.array_equal(got, want) or iou_err > 1e-6:
        raise AssertionError('host library paste or IoU differs from numpy')
    return ann_file, prefix


def _checkpoint(path):
    """A seeded Mask R-CNN Swin-T checkpoint (the flagship config)."""
    model = init_detector(CONFIG, device='cpu', seed=0)
    save_checkpoint(path, model, meta=dict(CLASSES=list(COCO_CLASSES)))


def _cli_run(phase, argv, what):
    """tools.test's main on ``argv``: its launches, counted from a reset,
    and what it returned, with the stages' seconds logged."""
    reset_launch_counts()
    with contextlib.redirect_stdout(None):
        ran = test_cli.main(argv)
    torch.cuda.synchronize()
    launches = launch_counts()
    times = ran['times']
    n = len(ran['results'])
    # per image its per-class boxes, beside its masks where there are any
    dets = [sum(len(b) for b in (r[0] if isinstance(r, tuple) else r))
            for r in ran['results']]
    log(phase, f'{what}: {n} images, {n / times["test"]:.3f} img/s '
               f'({times["test"]:.3f} s); detections per image {dets}; host '
               f'split (s): pipeline and decode {times["pipeline"]:.3f}, '
               f'device {times["device"]:.3f}, paste {times["paste"]:.3f}, '
               f'RLE encode {times["encode"]:.3f}, COCOeval '
               f'{times.get("evaluate", 0.0):.3f}')
    log(phase, f'{what}: kernel launches {launches}')
    return ran, launches, dets


def _check_eval_launches(phase, launches, nms_per_batch, batches):
    tc = _check_tc(phase, launches, True, _tc_kernels(False, False))
    idle = [fn.__name__ for fn in INFERENCE_KERNELS
            if not launches[fn.__name__]]
    trained = [fn.__name__ for fn in NOT_SERVING if launches[fn.__name__]]
    if idle or trained:
        raise AssertionError(f'{phase}: not launched {idle}, training '
                             f'kernels launched {trained}')
    if launches['nms_sorted'] != nms_per_batch * batches:
        raise AssertionError(f'{phase}: {launches["nms_sorted"]} NMS '
                             f'launches, expected {nms_per_batch} a batch')
    return tc


def _eval_outputs(model, dataset):
    """eval_batches' outputs of ``model`` on ``dataset`` (2 images a
    batch) and the formatted, RLE-encoded results."""
    batches, results = [], [None] * len(dataset)
    for chunk, out, metas in eval_batches(model, dataset, 2):
        batches.append((chunk, out, metas))
        for i, (b, m) in zip(chunk, format_results(out, metas, 80)):
            results[i] = (b, mask_ops.encode_mask_results(m))
    return batches, results


def _compare_eval(cpu, card, thr=0.5):
    """Card against CPU outputs, batch by batch: (box max|d|, mask pixels
    that differ where the CPU's pasted probability is not within
    TOL_EVAL_PROB of ``thr``, those near it, detections), or None for the
    box error where labels or slots differ."""
    box_err, bad, near, n = 0.0, 0, 0, 0
    for (chunk, want, metas), (_, got, _) in zip(cpu, card):
        if not (np.array_equal(want['det_valid'], got['det_valid'])
                and np.array_equal(want['labels'], got['labels'])):
            return None, None, None, None
        v = want['det_valid']
        box_err = max(box_err, float(np.abs(want['dets'][v]
                                            - got['dets'][v]).max()))
        for j, meta in enumerate(metas):
            h, w = meta['ori_shape'][:2]
            vj = v[j]
            p = mask_ops.paste_masks_reference(want['mask_probs'][j][vj],
                                      want['dets'][j][vj, :4], h, w,
                                      probs=True)
            sure = np.abs(p - thr) > TOL_EVAL_PROB
            diff = mask_ops.paste_masks(want['mask_probs'][j][vj],
                                     want['dets'][j][vj, :4], h, w, thr) \
                ^ mask_ops.paste_masks(got['mask_probs'][j][vj],
                                    got['dets'][j][vj, :4], h, w, thr)
            bad += int((diff & sure).sum())
            near += int((diff & ~sure).sum())
            n += int(vj.sum())
    return box_err, bad, near, n


def _scored_against(ds, truth, results):
    """COCOeval stats (bbox, segm) of ``results`` with the detections of
    ``truth`` as ground truth: 1 where the two agree."""
    _, segm = ds._segm2json(truth)
    gt = COCO()
    gt.dataset = dict(images=ds.coco.dataset['images'],
                      categories=ds.coco.dataset['categories'],
                      annotations=[dict(s, id=k + 1, iscrowd=0,
                                        area=mask_ops.rle_area(
                                            s['segmentation']))
                                   for k, s in enumerate(segm)])
    gt.createIndex()
    dets = ds._segm2json(results)
    return {t: _stats(gt, d, t) for t, d in zip(('bbox', 'segm'), dets)}


def eval_card_check(phase, root):
    """fp32 Mask R-CNN Swin-T with phase 5's spread heads on 2 of the PNGs
    (one landscape, one portrait: the CPU side of 4 took 69 of the
    phase's 89 s) at a 320x224 test scale, single_gpu_test's batches and the
    4-augmentation test's on the card (kernels) and on the CPU (plain
    versions): equal labels, boxes within TOL_EVAL_BOX, masks equal off
    the pixels near the threshold, metrics within TOL_EVAL_METRIC; a bf16
    control on the card must exceed the box limit."""
    sizes = LOOP_SIZES[:1] + LOOP_SIZES[4:5]
    ann_file, prefix = write_synthetic_coco(os.path.join(root, 'check'),
                                            sizes)
    opts = {'bf16': False, 'model.test_cfg.rpn.nms_pre': 1000,
            'model.test_cfg.rpn.max_per_img': 1000}
    cpu = init_detector(CONFIG, device='cpu', cfg_options=opts, seed=1)
    with torch.no_grad():
        cpu.rpn_head.rpn_cls.weight.mul_(100.0)
        cpu.roi_head.bbox_head.fc_cls.weight.mul_(100.0)
    card = init_detector(CONFIG, device='cpu', cfg_options=opts, seed=1)
    card.load_state_dict(cpu.state_dict())
    card = card.cuda()
    cpu_single = None
    for what, flip, scales in (('single', False, CHECK_SCALES[:1]),
                               ('tta', True, CHECK_SCALES)):
        t0 = time.perf_counter()
        cfg = eval_config(ann_file, prefix, scales, flip)
        ds = build_dataset(dict(cfg.data.test, test_mode=True))
        reset_launch_counts()
        got_b, got_r = _eval_outputs(card, ds)
        torch.cuda.synchronize()
        launches = launch_counts()
        _check_tc(f'{phase} fp32 {what}', launches, False,
                  _tc_kernels(False, False))
        if not all(launches[fn.__name__] for fn in INFERENCE_KERNELS):
            raise AssertionError(f'fp32 {what}: launches {launches}')
        want_b, want_r = _eval_outputs(cpu, ds)
        cpu_single = cpu_single or want_b
        box_err, bad, near, n = _compare_eval(want_b, got_b)
        if box_err is None or n == 0 or box_err > TOL_EVAL_BOX or bad:
            raise AssertionError(f'fp32 {what}: card against CPU: {n} '
                                 f'dets, box max|d| {box_err} (limit '
                                 f'{TOL_EVAL_BOX}), {bad} mask pixels off')
        with contextlib.redirect_stdout(None):
            m_cpu = ds.evaluate(want_r, metric=['bbox', 'segm'])
            m_card = ds.evaluate(got_r, metric=['bbox', 'segm'])
        m_err = max(abs(m_cpu[k] - m_card[k]) for k in m_cpu
                    if isinstance(m_cpu[k], float))
        log(phase, f'fp32 {what} ({len(scales) * (1 + flip)} augmentation'
                   f'(s)), card against CPU: {n} dets, labels equal, box '
                   f'max|d| {box_err:.3g} px, {near} mask pixels differ '
                   f'within {TOL_EVAL_PROB} of the threshold and none '
                   f'elsewhere, metrics max|d| {m_err:.3g} (bbox_mAP '
                   f'{m_card["bbox_mAP"]}, segm_mAP {m_card["segm_mAP"]}); '
                   f'{time.perf_counter() - t0:.1f} s')
        # the CPU's detections as ground truth: itself reads 1, the card
        # must read within TOL_EVAL_METRIC of it
        scored = {who: _scored_against(ds, want_r, r)
                  for who, r in (('cpu', want_r), ('card', got_r))}
        s_err = max(float(np.abs(scored['cpu'][t] - scored['card'][t]).max())
                    for t in ('bbox', 'segm'))
        log(phase, f'fp32 {what}: the card scored with the CPU\'s '
                   f'detections as ground truth, AP bbox '
                   f'{scored["card"]["bbox"][0]:.5f}, segm '
                   f'{scored["card"]["segm"][0]:.5f}; stats max|d| against '
                   f'the CPU scored so {s_err:.3g}')
        if m_err > TOL_EVAL_METRIC + 1e-9 or s_err > TOL_EVAL_METRIC \
                or scored['cpu']['bbox'][0] != 1.0:
            raise AssertionError(f'fp32 {what}: metrics differ by {m_err}, '
                                 f'scored against the CPU by {s_err}')
    # the bf16 control: the same weights computing in bf16 on the card
    cfg = eval_config(ann_file, prefix, CHECK_SCALES[:1])
    ds = build_dataset(dict(cfg.data.test, test_mode=True))
    control = init_detector(CONFIG, device='cpu', seed=1, cfg_options=dict(
        opts, bf16=True))
    control.load_state_dict(cpu.state_dict())
    control_b, _ = _eval_outputs(control.cuda(), ds)
    box_err, _, _, _ = _compare_eval(cpu_single, control_b)
    log(phase, f'bf16 control, card against CPU: box max|d| {box_err} '
               f'(None: the detections differ)')
    if box_err is not None and box_err <= TOL_EVAL_BOX:
        raise AssertionError(f'bf16 control within the fp32 box limit: '
                             f'{box_err}')


def phase_eval(phase='eval'):
    """Evaluation and test tools: COCOeval and the host library on this
    machine; the flagship in bf16 through tools.test on phase 10's 8 PNGs
    (score_thr 0, 100 detections an image), after a warm-up; the same
    with test-time augmentation (flip, 2 scales); then the fp32 card
    against CPU check. Returns the eval and TTA launches."""
    build_dir = os.path.join(REPO, 'build')
    os.makedirs(build_dir, exist_ok=True)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        ann_file, prefix = eval_checks(root, phase)
        log(phase, f'evaluator checks: {time.perf_counter() - start:.1f} s')
        cfg_file = os.path.join(root, 'eval_cfg.py')
        eval_config(ann_file, prefix).dump(cfg_file)
        ckpt = os.path.join(root, 'seeded.pth')
        _checkpoint(ckpt)
        base = [cfg_file, ckpt, '--samples-per-gpu', '2', '--cfg-options',
                'model.test_cfg.rcnn.score_thr=0.0']
        _cli_run(phase, base + ['--out', os.path.join(root, 'warm.pkl')],
                 'warm-up')
        ran, launches, dets = _cli_run(phase, base + ['--eval', 'bbox',
                                                      'segm'], 'bf16 test')
        if dets != [100] * 8 or not all(
                np.isfinite(v) for v in ran['metrics'].values()
                if isinstance(v, float)):
            raise AssertionError(f'bf16 test: detections {dets}, metrics '
                                 f'{ran["metrics"]}')
        tc = _check_eval_launches(phase, launches, 2, 4)
        log(phase, f'bf16 test: metrics {dict(ran["metrics"])}; '
                   f'tensor-core launches {tc}')
        tta = ['data.test.pipeline.1.img_scale=' + repr(TTA_SCALES),
               'data.test.pipeline.1.flip=True']
        ran, tta_launches, dets = _cli_run(
            phase, base + tta + ['--eval', 'bbox', 'segm'], 'bf16 TTA')
        if dets != [100] * 8:
            raise AssertionError(f'bf16 TTA: detections {dets}')
        # a batch: 4 RPN NMS, the merged proposals' and the final one
        _check_eval_launches(phase, tta_launches, 6, 4)
        log(phase, f'bf16 TTA: metrics {dict(ran["metrics"])}')
        log(phase, f'bf16 test and TTA: {time.perf_counter() - start:.1f} s '
                   f'into the phase')
        eval_card_check(phase, root)
    log(phase, f'done: {time.perf_counter() - start:.1f} s')
    return launches, tta_launches


# ------------------------------------------------------------- phase 12
CASCADE_CONFIG = os.path.join(
    REPO, 'configs/swin/cascade_mask_rcnn_swin_base_patch4_window7_'
    'mstrain_480-800_giou_4conv1f_adamw_3x_coco.py')
# the gradients the cascade's fp32 training check holds: the backbone, the
# FPN and the RPN as phase 7's, and every stage's heads, a normed shared
# conv and its BN of the last stage's among them
CASCADE_TRAIN_GRADS = TRAIN_GRADS[:5] + (
    'roi_head.bbox_head.0.fc_cls.weight',
    'roi_head.bbox_head.1.shared_fcs.0.weight',
    'roi_head.bbox_head.2.shared_convs.0.conv.weight',
    'roi_head.bbox_head.2.shared_convs.0.bn.weight',
    'roi_head.bbox_head.2.fc_reg.weight',
    'roi_head.mask_head.1.convs.0.conv.weight')
# Limits of the cascade's fp32 card-vs-CPU training check, where they
# differ from phase 7's (NVIDIA H100 80GB HBM3, 700.00 W; 224x320, pinned
# proposals, the first card runs of this check): the box losses are GIoU on decoded boxes, 1 - GIoU of
# rois already near their gts (stage 2's loss_bbox 7e-4), where fp32
# cancellation and the boxes' fp32 noise read 2.4e-5 relative (the bf16
# control 5.6e-3); and the bbox group's gradients pass back through four
# BN layers a head, whose backward amplifies the roi features' fp32
# noise (a normed shared conv's weight read 5.6e-3, the patch
# embedding's 3.6e-3; the control 0.09-0.67 at the same parameters; on
# the CPU a random perturbation of 2e-5 of the features' largest entry
# moves them by 1e-2 in float64, tests/test_torch_cascade.py).
CASCADE_TRAIN_LIMITS = ({f's{i}.loss_bbox': 1e-4 for i in range(3)},
                        dict(TOL_TRAIN_GRAD, bbox=2e-2))
# The cuts of the cascade's two fp32 card-vs-CPU checks, whose CPU side
# took 73 s of phase 12's 122 s (NVIDIA H100 80GB HBM3's host, 700.00 W):
# Swin-B's widths with two blocks a stage, where the config has (2, 2, 18,
# 2); the serving and training timings keep the full depth, and phase 3
# holds the LayerNorm and attention kernels at every Swin-B shape. At
# that depth the training check's CPU run still took 37.0 s, 36 s of it
# (on this repo's CPU profile) in the plain RoIAlign forward and
# backward, so it also samples CHECK_ROIS rois a stage an image where the
# config samples 512; its proposals stay pinned, so no boundary moves
CASCADE_CHECK_DEPTHS = [2, 2, 2, 2]
CASCADE_CHECK_OPTS = {'model.backbone.depths': CASCADE_CHECK_DEPTHS}
CASCADE_TRAIN_CHECK_OPTS = {
    **CASCADE_CHECK_OPTS,
    **{f'model.train_cfg.rcnn.{i}.sampler.num': CHECK_ROIS
       for i in range(3)}}
# the cascade's loop: 2 landscape and 2 portrait PNGs of phase 10's sizes,
# 2 iterations of 2 images; its test run takes the first 2
CASCADE_LOOP_SIZES = LOOP_SIZES[:2] + LOOP_SIZES[4:6]


def cascade_launches(model, training):
    """Each kernel's launches that one request (serving) or one step
    (training, the whole batch at once) of the cascade makes, derived from
    the built model: a LayerNorm launch per Swin norm (the patch
    embedding's, two a block, the merges' and the outputs'), an attention
    launch per block (its training forward and backward in training), a
    conv3x3 launch per FPN output conv, per RPN level (the shared RPN conv)
    and per mask-head conv of every stage, in training a second one each
    for dx and a filter-gradient launch each (the bbox heads' normed convs
    run F.conv2d, as the JAX package sends only bias-and-no-norm convs to
    its kernel); a RoIAlign launch per stage's bbox head and one for the
    mask heads when serving (one RoIAlign the three share), one per stage
    for the bbox and the mask head in training, each with its backward;
    NMS twice a request (RPN, multiclass), once a step (RPN)."""
    from swindet_tpu_torch.models.backbones.swin import LayerNorm
    roi = model.roi_head
    norms = sum(isinstance(m, LayerNorm) for m in model.modules())
    blocks = sum(isinstance(m, WindowAttention) for m in model.modules())
    convs = sum(c.use_kernel for c in model.neck.fpn_convs) \
        + model.neck.num_outs * model.rpn_head.conv_uses_kernel \
        + sum(c.use_kernel for h in roi.mask_head for c in h.convs)
    want = {fn.__name__: 0 for fn in KERNEL_WRAPPERS}
    want['layer_norm'] = norms
    if training:
        want.update(window_attention_fwd_p=blocks,
                    window_attention_bwd=blocks, conv3x3=2 * convs,
                    conv3x3_dw=convs, roi_align=2 * roi.num_stages,
                    roi_align_bwd=2 * roi.num_stages, nms_sorted=1)
    else:
        want.update(window_attention_v3=blocks, conv3x3=convs,
                    roi_align=roi.num_stages + 1, nms_sorted=2)
    return want


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _check_launches(phase, got, per, times):
    want = {k: v * times for k, v in per.items()}
    if got != want:
        raise AssertionError(f'{phase}: launches {_nonzero(got)}, expected '
                             f'{_nonzero(want)}')


def cascade_serve(phase='cascade'):
    """Cascade Mask R-CNN Swin-B from its config, bf16, through
    init_detector and inference_detector: a warm-up, then 3 requests at
    800x1333 with every launch count checked."""
    t0 = time.perf_counter()
    model = init_detector(CASCADE_CONFIG, device='cuda', seed=0)
    _check_blocks(model, False, False)
    per = cascade_launches(model, training=False)
    log(phase, f'init_detector: {type(model).__name__} '
               f'{sum(p.numel() for p in model.parameters())} params, '
               f'compute {model.dtype}, {per["window_attention_v3"]} Swin '
               f'blocks, {model.roi_head.num_stages} stages, '
               f'{time.perf_counter() - t0:.1f} s; launches per request '
               f'{_nonzero(per)}')
    imgs = synthetic_images(3, seed=5)
    t0 = time.perf_counter()
    _check_result(inference_detector(model, imgs[0]), 800, 1333)
    torch.cuda.synchronize()
    log(phase, f'warm-up request {time.perf_counter() - t0:.3f} s')
    reset_launch_counts()
    lat, counts = [], []
    for img in imgs:
        t0 = time.perf_counter()
        res = inference_detector(model, img)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        counts.append(_check_result(res, 800, 1333))
    launches = launch_counts()
    log(phase, 'per-request latency (s): '
               + ', '.join(f'{t:.4f}' for t in lat)
               + f'; detections per image: {counts}; {CARD}')
    _check_launches(phase, launches, per, len(imgs))
    tc = _check_tc(phase, launches, True, _tc_kernels(False, False))
    log(phase, f'kernel launches over the 3 requests {launches}, as '
               f'derived; tensor-core {tc}')
    return launches, lat


def cascade_train(phase='cascade-train'):
    """1 + 5 make_train_step steps of the cascade (its config: bf16,
    drop_path_rate 0.3, AdamW with the Swin paramwise_cfg) at batch 2 on
    the 800x1344 canvas, with each step's launches checked; the BN
    buffers move in a step and not in a validation pass; 2 profiled
    steps."""
    cfg = Config.fromfile(CASCADE_CONFIG)
    model = init_detector(cfg, device='cuda', seed=0)
    opt = build_optimizer(model, dict(cfg.optimizer))
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH)
    step = make_train_step(model, opt, schedule,
                           dict(cfg.optimizer_config).get('grad_clip'))
    per = cascade_launches(model, training=True)
    batch = synthetic_train_batch()
    gen = torch.Generator(device='cuda').manual_seed(0)
    stats = {k: v.clone() for k, v in model.named_buffers()
             if k.endswith(('running_mean', 'running_var'))}
    t0 = time.perf_counter()
    _check_log(step(batch, gen), 'warm-up step')
    torch.cuda.synchronize()
    log(phase, f'warm-up step {time.perf_counter() - t0:.3f} s; launches '
               f'per step {_nonzero(per)}')
    moved = [k for k, v in model.named_buffers()
             if k in stats and not torch.equal(v, stats[k])]
    if len(moved) != len(stats) or not stats:
        raise AssertionError(f'{len(moved)} of {len(stats)} BN running '
                             f'statistics moved in a step')
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_log(out, 'timed step')
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(phase, 'per-step ms: ' + ', '.join(f'{t:.1f}' for t in times)
               + f'; median {np.median(times):.1f}; peak memory '
                 f'{peak / 2 ** 30:.2f} GiB; {CARD}')
    log(phase, 'last step: ' + ', '.join(f'{k} {v:.4f}'
                                         for k, v in out.items()))
    _check_launches(phase, launches, per, 5)
    tc = _check_tc(phase, launches, True, _tc_kernels(False))
    log(phase, f'kernel launches over the 5 timed steps {launches}, as '
               f'derived; tensor-core {tc}')
    stats = {k: v.clone() for k, v in model.named_buffers() if k in stats}
    with torch.inference_mode():
        model.eval()
        res = model.simple_test(batch['img'], batch['img_shapes'],
                                torch.ones((2, 4), device=batch['img'].device))
        model.train()
    if not torch.isfinite(res['dets']).all() or any(
            not torch.equal(v, stats[k]) for k, v in model.named_buffers()
            if k in stats):
        raise AssertionError('validation pass: non-finite detections or '
                             'moved BN statistics')
    log(phase, 'validation pass (eval mode): finite detections, BN '
               'running statistics unchanged')
    busy = _profile_steps(step, batch, gen, float(np.median(times)), phase)
    log(phase, f'median step {np.median(times):.1f} ms, busy {busy:.3f}, '
               f'peak {peak / 2 ** 30:.2f} GiB on {CARD}')
    return launches, times, peak, busy


def cascade_files(phase='cascade-files'):
    """The cascade config's own train pipeline (both AutoAugment branches,
    the absolute_range RandomCrop) through train_detector for 2
    iterations on 4 of phase 10's PNGs, then tools.test on 2 of them with
    the trained checkpoint, plain and with test-time augmentation, --eval
    bbox segm, score_thr 0 (100 detections an image)."""
    build_dir = os.path.join(REPO, 'build')
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        ann_file, prefix = write_synthetic_coco(root, CASCADE_LOOP_SIZES)
        work = os.path.join(root, 'work')
        cfg = loop_config(ann_file, prefix, work, config=CASCADE_CONFIG)
        model_cfg = dict(cfg.model, dtype='bfloat16')
        model_cfg.pop('pretrained', None)
        model = build_detector(model_cfg)
        reset_launch_counts()
        t0 = time.perf_counter()
        run = train_detector(model, build_dataset(cfg.data.train), cfg)
        torch.cuda.synchronize()
        launches = launch_counts()
        log(phase, f'train_detector: {len(run.log_vars)} iterations in '
                   f'{time.perf_counter() - t0:.1f} s, canvases '
                   f'{run.canvases}; loss '
                   + ', '.join(f'{v["loss"]:.4g}' for v in run.log_vars)
                   + '; grad_norm '
                   + ', '.join(f'{v["grad_norm"]:.4g}' for v in run.log_vars))
        bad = [v for v in run.log_vars
               if not all(np.isfinite(x) for x in v.values())]
        per = cascade_launches(model, training=True)
        if len(run.log_vars) != 2 or bad \
                or any(bool(launches[k]) != bool(v) for k, v in per.items()):
            raise AssertionError(f'the loop: {len(run.log_vars)} '
                                 f'iterations, non-finite {bad}, launches '
                                 f'{launches}')
        ckpt = os.path.join(work, 'epoch_1.pth')
        test_ann = os.path.join(root, 'test.json')
        with open(ann_file) as f:
            coco = json.load(f)
        keep = {im['id'] for im in coco['images'][:2]}
        coco['images'] = coco['images'][:2]
        coco['annotations'] = [a for a in coco['annotations']
                               if a['image_id'] in keep]
        with open(test_ann, 'w') as f:
            json.dump(coco, f)
        cfg_file = os.path.join(root, 'cascade_cfg.py')
        eval_config(test_ann, prefix, config=CASCADE_CONFIG).dump(cfg_file)
        # score_thr 0: 100 detections an image, as trained weights give
        base = [cfg_file, ckpt, '--samples-per-gpu', '2', '--eval', 'bbox',
                'segm', '--cfg-options', 'model.test_cfg.rcnn.score_thr=0.0']
        out = {}
        for what, nms, extra in (
                ('test', 2, []),
                ('TTA', 6, ['data.test.pipeline.1.img_'
                            f'scale={TTA_SCALES!r}',
                            'data.test.pipeline.1.flip=True'])):
            ran, launches, dets = _cli_run(phase, base + extra, what)
            trained = [fn.__name__ for fn in NOT_SERVING
                       if launches[fn.__name__]]
            if dets != [100, 100] or trained \
                    or launches['nms_sorted'] != nms \
                    or not launches['roi_align'] or not all(
                        np.isfinite(v) for v in ran['metrics'].values()
                        if isinstance(v, float)):
                raise AssertionError(f'{what}: detections {dets}, training '
                                     f'kernels {trained}, launches '
                                     f'{launches}, metrics {ran["metrics"]}')
            _check_tc(phase, launches, True, _tc_kernels(False, False))
            log(phase, f'{what}: metrics {dict(ran["metrics"])}')
            out[what] = launches
    return out


def phase_cascade():
    """Phase 12: Cascade Mask R-CNN Swin-B serving, its fp32 serving check,
    training, its fp32 training check (both checks cut:
    CASCADE_CHECK_OPTS, CASCADE_TRAIN_CHECK_OPTS) and the loop and test
    tool from files. Returns the serving and training launches."""
    start = last = time.perf_counter()
    laps = []

    def lap(what):
        nonlocal last
        now = time.perf_counter()
        laps.append(f'{what} {now - last:.1f} s')
        log('time', f'cascade: {laps[-1]}')
        last = now
    serve, lat = cascade_serve()
    lap('serving')
    phase_check(phase='cascade-check', config=CASCADE_CONFIG, control=True,
                cfg_options=CASCADE_CHECK_OPTS)
    lap('serving check')
    train, times, peak, busy = cascade_train()
    lap('training')
    phase_train_check(config=CASCADE_CONFIG, names=CASCADE_TRAIN_GRADS,
                      pin_proposals=True, limits=CASCADE_TRAIN_LIMITS,
                      opts=(('bf16', False),
                            ('model.backbone.drop_path_rate', 0.0),
                            *CASCADE_TRAIN_CHECK_OPTS.items()))
    lap('training check')
    cascade_files()
    lap('files')
    log('time', f'cascade: ' + ', '.join(laps)
                + f'; phase 12 {time.perf_counter() - start:.1f} s')
    return dict(serve=serve, lat=lat, train=train, times=times, peak=peak,
                busy=busy)


# ------------------------------------------------------------- phase 13
REPPOINTS_CONFIG = os.path.join(
    REPO, 'configs/reppoints/'
    'reppoints_moment_swin_tiny_fpn_mstrain_3x_coco.py')
# the config computes in fp32 as written (its r50 base has no bf16 switch);
# the phase serves and trains it in bf16, as the Swin configs
REPPOINTS_BF16 = {'bf16': True}
# the gradients RepPoints' fp32 training check holds: the class and
# refined-point deformable convs, the initial points' output, the moment
# transfer (each behind a detach trick), a stacked head conv, the FPN's
# first extra conv and a backbone qkv weight (tests/test_torch_reppoints.py
# holds the same list on the CPU)
REPPOINTS_TRAIN_GRADS = (
    'bbox_head.reppoints_cls_conv.weight',
    'bbox_head.reppoints_pts_refine_conv.weight',
    'bbox_head.reppoints_pts_init_out.weight',
    'bbox_head.moment_transfer',
    'bbox_head.cls_convs.0.conv.weight',
    'neck.fpn_convs.3.conv.weight',
    'backbone.layers.0.blocks.0.attn.qkv.weight')
# Limits of RepPoints' fp32 card-vs-CPU training check: phase 7's loss
# limit and its RPN group's gradient limit, the dense head's
REPPOINTS_TRAIN_LIMITS = (TOL_TRAIN_LOSS, TOL_TRAIN_GRAD['rpn'])
# pairs (point, class) of the warm-up request that clear score_thr once
# the class output's bias is set: twice the 2,048-pair cap of the NMS
REPPOINTS_PAIRS = 4096
# a refine-stage IoU within this of 0.4 or 0.5, or of its gt's best IoU,
# may assign apart on the card and the CPU (fp32 noise in the initial
# boxes)
REPPOINTS_IOU_NOISE = 1e-4
# the loop's PNGs: 2 landscape images of phase 10's sizes, one batch
REPPOINTS_LOOP_SIZES = LOOP_SIZES[:2]


def reppoints_launches(model, training):
    """Each kernel's launches that one request (serving) or one step
    (training, the whole batch at once) of RepPoints makes, derived from
    the built model: a LayerNorm launch per Swin norm, an attention launch
    per block (its training forward and backward in training), a conv3x3
    launch per FPN output conv and per stacked head conv on every level
    (in training one more each for dx and a filter-gradient launch each;
    the FPN's stride-2 extra convs and the initial points' 3x3 conv run
    F.conv2d, as the JAX package sends only stride-1 ConvModules to its
    kernel), NMS once a request (multiclass) and never in training."""
    from swindet_tpu_torch.models.backbones.swin import LayerNorm
    head = model.bbox_head
    norms = sum(isinstance(m, LayerNorm) for m in model.modules())
    blocks = sum(isinstance(m, WindowAttention) for m in model.modules())
    convs = sum(c.use_kernel for c in model.neck.fpn_convs) \
        + len(head.point_strides) * sum(
            c.use_kernel for c in (*head.cls_convs, *head.reg_convs))
    want = {fn.__name__: 0 for fn in KERNEL_WRAPPERS}
    want['layer_norm'] = norms
    if training:
        want.update(window_attention_fwd_p=blocks,
                    window_attention_bwd=blocks, conv3x3=2 * convs,
                    conv3x3_dw=convs)
    else:
        want.update(window_attention_v3=blocks, conv3x3=convs, nms_sorted=1)
    return want


def _check_bbox_result(res, h, w):
    """An 80-class bbox-only result (per class (k, 5) arrays in the image's
    frame); returns the number of detections."""
    if len(res) != 80:
        raise AssertionError(f'{len(res)} classes of results, expected 80')
    n = 0
    for dets in res:
        if dets.ndim != 2 or dets.shape[1] != 5 \
                or not np.isfinite(dets).all() \
                or (dets[:, [0, 2]] > w + 1e-3).any() \
                or (dets[:, [1, 3]] > h + 1e-3).any() or (dets < 0).any():
            raise AssertionError(f'bad detections {dets.shape}')
        n += len(dets)
    if n > 100:
        raise AssertionError(f'{n} detections, over max_per_img 100')
    return n


def _candidate_logits(model, img):
    """The class logits of one request's pre-NMS candidates (the head's
    per-level top nms_pre points), one row per candidate."""
    from swindet_tpu_torch.apis.inference import preprocess_images
    batch = preprocess_images([img], model.cfg)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        _, scores, _ = model.aug_bbox_test(
            torch.from_numpy(batch['img']).to(dev),
            torch.from_numpy(batch['img_shapes']).to(dev))
    return torch.logit(scores[0, :, :-1].double())


def reppoints_serve(phase='reppoints'):
    """RepPoints-moment Swin-T from its config in bf16 through
    init_detector and inference_detector: the class output's bias set so
    that REPPOINTS_PAIRS (point, class) pairs of the warm-up request clear
    score_thr, a warm-up, then 3 requests at 800x1333 with every launch
    count checked."""
    t0 = time.perf_counter()
    model = init_detector(REPPOINTS_CONFIG, device='cuda', seed=0,
                          cfg_options=REPPOINTS_BF16)
    _check_blocks(model, False, False)
    per = reppoints_launches(model, training=False)
    head = model.bbox_head
    log(phase, f'init_detector: {type(model).__name__} '
               f'{sum(p.numel() for p in model.parameters())} params, '
               f'compute {model.dtype}, {per["window_attention_v3"]} Swin '
               f'blocks, {len(head.cls_convs)} stacked convs a branch, '
               f'{head.num_points} points, strides {head.point_strides}, '
               f'{time.perf_counter() - t0:.1f} s; launches per request '
               f'{_nonzero(per)}')
    imgs = synthetic_images(3, seed=7)
    thr = dict(model.test_cfg)['score_thr']
    # seeded weights score every pair near the 0.01 prior, under score_thr:
    # a uniform shift of the bias moves every logit alike, and so neither
    # the candidates nor their order
    logits = _candidate_logits(model, imgs[0])
    kth = torch.topk(logits.flatten(), REPPOINTS_PAIRS).values[-1].item()
    shift = float(np.log(thr / (1 - thr))) - kth + 1e-3
    with torch.no_grad():
        head.reppoints_cls_out.bias.add_(shift)
    pairs = int((_candidate_logits(model, imgs[0]).sigmoid() > thr).sum())
    log(phase, f'reppoints_cls_out bias {head.reppoints_cls_out.bias[0]:.4f} '
               f'(prior {-np.log(99):.4f}, shifted by {shift:.4f}): '
               f'{pairs} of {logits.numel()} candidate pairs of the warm-up '
               f'request clear score_thr {thr}')
    if pairs < REPPOINTS_PAIRS // 2:
        raise AssertionError(f'{pairs} pairs clear score_thr: the NMS cap '
                             f'of {REPPOINTS_PAIRS // 2} is not full')
    t0 = time.perf_counter()
    _check_bbox_result(inference_detector(model, imgs[0]), 800, 1333)
    torch.cuda.synchronize()
    log(phase, f'warm-up request {time.perf_counter() - t0:.3f} s')
    reset_launch_counts()
    lat, counts = [], []
    for img in imgs:
        t0 = time.perf_counter()
        res = inference_detector(model, img)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        counts.append(_check_bbox_result(res, 800, 1333))
    launches = launch_counts()
    log(phase, 'per-request latency (s): '
               + ', '.join(f'{t:.4f}' for t in lat)
               + f'; detections per image: {counts}; {CARD}')
    if min(counts) < 100:
        raise AssertionError(f'detections {counts}: max_per_img 100 not '
                             f'reached with the cap full')
    _check_launches(phase, launches, per, len(imgs))
    tc = _check_tc(phase, launches, True, _tc_kernels(False, False))
    log(phase, f'kernel launches over the 3 requests {_nonzero(launches)}, '
               f'as derived; tensor-core {_nonzero(tc)}')
    return launches, lat


def _rp_outputs(model, dev, img, shapes, sf):
    args = [torch.from_numpy(a).to(dev) for a in (img, shapes, sf)]
    with torch.inference_mode():
        feats = model.extract_feat(args[0])
        out = model.simple_test(*args)
        _, scores, _ = model.aug_bbox_test(args[0], args[1], feats=feats)
    return ([f.cpu().float() for f in feats],
            {k: v.cpu() for k, v in out.items()}, scores.cpu())


def _rp_errors(want, got):
    """FPN features' relative max |d|, and None where the detections or
    labels differ, else (box max |d|, score max |d|, detections)."""
    (f_w, o_w, _), (f_g, o_g, _) = want, got
    feat_err = max((a - b).abs().max().item() / max(a.abs().max().item(), 1)
                   for a, b in zip(f_w, f_g))
    if not torch.equal(o_w['det_valid'], o_g['det_valid']) \
            or not torch.equal(o_w['labels'], o_g['labels']):
        return feat_err, None
    return feat_err, ((o_w['dets'][..., :4] - o_g['dets'][..., :4]).abs()
                      .max().item(),
                      (o_w['dets'][..., 4] - o_g['dets'][..., 4]).abs()
                      .max().item(), int(o_w['det_valid'].sum()))


def _level_logits(model, img):
    """The class logits of every point (or anchor) of every level, one
    row each, fp64 on the CPU."""
    c_out = model.bbox_head.cls_out_channels
    with torch.inference_mode():
        cls = model.bbox_head(model.extract_feat(img))[0]
    return [c.reshape(-1, c_out).double().cpu() for c in cls]


def _set_class_logits(model, img, mean=-14.0, std=4.0, margin=2e-4,
                      conv=None, candidates=True):
    """Scale the class output's weight (``conv``, RepPoints'
    reppoints_cls_out by default) and set its bias so that the class
    logits of ``img`` have ``mean`` and ``std`` (a few hundred (point,
    class) pairs clear score_thr 0.05, under the 2,048-pair cap), then
    shift the bias by steps of 0.01 until every decision of get_bboxes
    and the NMS's entry sits ``margin`` or more from its boundary in
    logit units (_logit_margins): four times the largest fp32 difference
    of a logit between the card and the CPU that the FPN features' (3.4e-6
    of their largest entry on an H100) allow through a |logit| of 14.
    ``candidates`` as _logit_margins takes it. Returns the scale, the bias
    and the margins."""
    conv = model.bbox_head.reppoints_cls_out if conv is None else conv
    # the logits without the bias, which fp32 would round to its own
    # resolution (seeded logits spread by ~1e-4 around the -4.6 prior)
    with torch.no_grad():
        prior = conv.bias.clone()
        conv.bias.zero_()
        z = _level_logits(model, img)
        conv.bias.copy_(prior)
    flat = torch.cat(z)
    scale = std / flat.std().item()
    base = mean - scale * flat.mean().item()
    cfg = dict(model.test_cfg)
    for k in range(41):
        bias = base + 0.01 * (k // 2 if k % 2 else -(k // 2))
        margins = _logit_margins([scale * lz + bias for lz in z],
                                 cfg['nms_pre'], cfg['score_thr'],
                                 candidates=candidates)
        if min(m for m in margins[:3] if m is not None) >= margin:
            break
    else:
        raise AssertionError(f'no bias within 0.2 of {base:.3f} keeps the '
                             f'logits {margin} from their boundaries: '
                             f'{margins}')
    with torch.no_grad():
        conv.weight.mul_(scale)
        conv.bias.fill_(bias)
    return scale, bias, margins


def _logit_margins(logits, nms_pre, thr, cap=2048, candidates=True):
    """How far the decisions of get_bboxes and the multiclass NMS sit from
    their boundaries, in logits, given every level's class logits: the
    nearest logit to score_thr's, the smallest gap at a level's top
    nms_pre cut (None where no level is cut, or with ``candidates`` False
    where every cut lies under score_thr's logit: which of two anchors
    under it takes a level's last slot then moves the candidates only,
    not the detections), and the gap at the cap's last pair (None under
    the cap); and the pairs that clear score_thr."""
    t = float(np.log(thr / (1 - thr)))
    cand, cuts = [], []
    for z in logits:
        best = torch.sort(z.amax(-1), descending=True)
        if 0 < nms_pre < len(best.values):
            if candidates or best.values[nms_pre - 1] > t:
                cuts.append((best.values[nms_pre - 1]
                             - best.values[nms_pre]).item())
            z = z[best.indices[:nms_pre]]
        cand.append(z.flatten())
    cand = torch.cat(cand)
    top = torch.sort(cand[cand > t], descending=True).values
    return ((cand - t).abs().min().item(), min(cuts) if cuts else None,
            (top[cap - 1] - top[cap]).item() if len(top) > cap else None,
            len(top))


def reppoints_check(device='cuda', phase='reppoints-check', control=True):
    """Phase 5's check on RepPoints: fp32 on a 224x320 canvas, the card
    (kernels) against the CPU (plain versions), same seeded weights with
    reppoints_cls_out set so that no per-level top-k, score_thr or NMS
    cap boundary sits within fp32 noise (_set_class_logits; the margins
    are logged); the card's launches as reppoints_launches derives them,
    none on tensor cores; a bf16 control that must exceed the limits."""
    opts = {'bf16': False}
    cpu = init_detector(REPPOINTS_CONFIG, device='cpu', cfg_options=opts,
                        seed=1)
    rs = np.random.RandomState(1)
    img = rs.randn(1, 224, 320, 3).astype(np.float32)
    shapes = np.array([[224, 320]], np.int32)
    sf = np.ones((1, 4), np.float32)
    scale, bias, (thr_gap, cut_gap, cap_gap, pairs) = _set_class_logits(
        cpu, torch.from_numpy(img))
    log(phase, f'reppoints_cls_out weight x{scale:.4g}, bias {bias:.4g}: '
               f'{pairs} candidate pairs clear score_thr '
               f'{dict(cpu.test_cfg)["score_thr"]}; in logits, the nearest '
               f'to score_thr\'s {thr_gap:.3g} away, the smallest gap at a '
               f'level\'s top-{dict(cpu.test_cfg)["nms_pre"]} cut '
               f'{cut_gap}, at the 2048-pair cap {cap_gap}')
    gpu = _copy_model(cpu, 'float32', device)
    gpu = gpu.to(device).eval()
    want = _rp_outputs(cpu, 'cpu', img, shapes, sf)
    reset_launch_counts()
    got = _rp_outputs(gpu, device, img, shapes, sf)
    if device == 'cuda':
        per = reppoints_launches(gpu, training=False)
        # simple_test and the candidates' pass, each a request's worth but
        # the latter's NMS
        per2 = {k: 2 * v - (k == 'nms_sorted') for k, v in per.items()}
        _check_launches(phase, launch_counts(), per2, 1)
        _check_tc(phase, launch_counts(), False, _tc_kernels(False, False))
    feat_err, errs = _rp_errors(want, got)
    # the candidates as sorted sets: near-tied points may take their top-k
    # slots in another order
    cand_err = (torch.sort(want[2].flatten()).values
                - torch.sort(got[2].flatten()).values).abs().max().item()
    if errs is None:
        raise AssertionError('detections differ between card and CPU')
    box_err, score_err, n = errs
    log(phase, f'224x320 fp32 card vs CPU: features rel max|d| '
               f'{feat_err:.3g}, {n} dets equal, box max|d| {box_err:.3g} px, '
               f'score max|d| {score_err:.3g}, candidate scores (sorted) '
               f'max|d| {cand_err:.3g}')
    if feat_err > 1e-3 or n == 0 or box_err > 1e-2 \
            or max(score_err, cand_err) > 1e-4:
        raise AssertionError('card vs CPU over the limits: features 1e-3, '
                             'boxes 1e-2 px, scores 1e-4')
    if not control:
        return
    ctl = _copy_model(cpu, 'bfloat16', device)
    feat_err, errs = _rp_errors(want, _rp_outputs(ctl.to(device).eval(),
                                                  device, img, shapes, sf))
    log(phase, f'bf16 control vs the fp32 CPU run: features rel max|d| '
               f'{feat_err:.3g}, detections '
               + ('differ' if errs is None else
                  f'equal, box max|d| {errs[0]:.3g}, score max|d| '
                  f'{errs[1]:.3g}'))
    if errs is not None and feat_err <= 1e-3 and errs[0] <= 1e-2 \
            and errs[1] <= 1e-4:
        raise AssertionError('the bf16 control passes the fp32 limits')


def _deform_conv_ms(model, batch, phase, iters=3):
    """The device ms of the head's deformable convs in one training step,
    forward and backward apart: each call's inputs are taken from a
    training forward of ``batch``, then each call runs again on them
    (input, offsets and weight with gradients, as in the step) under
    torch.profiler, its forward and its backward each summed over every
    kernel they launch. Returns (forward ms, backward ms, calls)."""
    head = model.bbox_head
    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: calls.append((mod, args[0].detach().clone(),
                                        args[1].detach().clone())))
        for m in (head.reppoints_cls_conv, head.reppoints_pts_refine_conv)]
    try:
        with torch.no_grad():
            model.forward_train(batch['img'], batch['img_shapes'],
                                batch['pad_shapes'], batch['gt_bboxes'],
                                batch['gt_valid'], batch['gt_labels'],
                                gen=torch.Generator(device='cuda')
                                .manual_seed(1))
    finally:
        for h in hooks:
            h.remove()

    def device_ms(fn):
        return _kernel_device_ms(fn, {'all': ''}, iters)['all']

    fwd = bwd = 0.0
    rows = []
    for mod, x, off in calls:
        x.requires_grad_(True)
        off.requires_grad_(True)
        f_ms = device_ms(lambda: mod(x, off))
        out = mod(x, off)
        g = torch.randn_like(out)

        def backward():
            torch.autograd.grad(out, (x, off, mod.weight), g,
                                retain_graph=True)
        b_ms = device_ms(backward)
        rows.append(f'{tuple(x.shape[1:3])} {f_ms:.3f}+{b_ms:.3f}')
        fwd += f_ms
        bwd += b_ms
    log(phase, f'deformable convs, {len(calls)} calls a step (level: '
               f'forward+backward ms): ' + ', '.join(rows))
    return fwd, bwd, len(calls)


def reppoints_train(phase='reppoints-train'):
    """1 + 5 make_train_step steps of RepPoints (its config in bf16:
    drop_path_rate 0.2, AdamW with the Swin paramwise_cfg) at batch 2 on
    the 800x1344 canvas with 16 painted rectangles an image and no
    gt_masks, each step's launches checked; 2 profiled steps; the
    deformable convs' device ms."""
    cfg = Config.fromfile(REPPOINTS_CONFIG)
    cfg.merge_from_dict(REPPOINTS_BF16)
    model = init_detector(cfg, device='cuda', seed=0)
    opt = build_optimizer(model, dict(cfg.optimizer))
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH)
    step = make_train_step(model, opt, schedule,
                           dict(cfg.optimizer_config).get('grad_clip'))
    per = reppoints_launches(model, training=True)
    batch = synthetic_train_batch()
    del batch['gt_masks']
    gen = torch.Generator(device='cuda').manual_seed(0)
    t0 = time.perf_counter()
    _check_log(step(batch, gen), 'warm-up step')
    torch.cuda.synchronize()
    log(phase, f'warm-up step {time.perf_counter() - t0:.3f} s; launches '
               f'per step {_nonzero(per)}')
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_log(out, 'timed step')
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(phase, 'per-step ms: ' + ', '.join(f'{t:.1f}' for t in times)
               + f'; median {np.median(times):.1f}; peak memory '
                 f'{peak / 2 ** 30:.2f} GiB; {CARD}')
    log(phase, 'last step: ' + ', '.join(f'{k} {v:.4f}'
                                         for k, v in out.items()))
    _check_launches(phase, launches, per, 5)
    tc = _check_tc(phase, launches, True, _tc_kernels(False))
    log(phase, f'kernel launches over the 5 timed steps {_nonzero(launches)}'
               f', as derived; tensor-core {_nonzero(tc)}')
    busy = _profile_steps(step, batch, gen, float(np.median(times)), phase)
    fwd, bwd, n = _deform_conv_ms(model, batch, phase)
    log(phase, f'median step {np.median(times):.1f} ms, busy {busy:.3f}, '
               f'peak {peak / 2 ** 30:.2f} GiB; the {n} deformable convs '
               f'{fwd:.2f} ms forward + {bwd:.2f} ms backward a step; on '
               f'{CARD}')
    return launches, times, peak, busy, (fwd, bwd)


def _refine_targets(model, record=None, replay=None):
    """Wrap the head's target step: ``record`` (a list) keeps each stage's
    targets on the CPU; ``replay`` (such a list) makes the refined stage
    read those in place of its own (the init stage's assigner sees the
    grid points only, the same on both devices)."""
    head = model.bbox_head
    own = head._targets

    def targets(assigner, cands, *args):
        out = own(assigner, cands, *args)
        if record is not None:
            record.append((cands.detach().cpu(), [t.cpu() for t in out]))
        if replay is not None and assigner is head.refine_assigner:
            out = [t.to(cands.device) for t in replay[1]]
        return out
    head._targets = targets
    return lambda: head.__dict__.pop('_targets', None)


def _iou_margin(model, boxes, batch):
    """The refine stage's nearest IoU to its thresholds (0.4, 0.5), per gt
    the gap between its best and next-best box (the low-quality match's
    equality) and per box the gap between its best and next-best gt (the
    argmax), over the CPU run's initial boxes (B, N, 4)."""
    from swindet_tpu_torch.core.bbox import bbox_overlaps
    a = model.bbox_head.refine_assigner
    margin = float('inf')
    for i in range(boxes.shape[0]):
        gv = torch.from_numpy(batch['gt_valid'][i])
        iou = bbox_overlaps(boxes[i].double(), torch.from_numpy(
            batch['gt_bboxes'][i]).double())[:, gv]
        for t in (a.pos_iou_thr, a.neg_iou_thr):
            margin = min(margin, (iou - t).abs().min().item())
        top2 = iou.topk(2, dim=0).values
        margin = min(margin, (top2[0] - top2[1]).min().item())
        if iou.shape[1] > 1:
            top2 = iou.topk(2, dim=1).values
            near = top2[:, 0] >= a.neg_iou_thr
            if near.any():
                margin = min(margin, (top2[near, 0] - top2[near, 1])
                             .min().item())
    return margin


def _rp_train_grads(model, batch, dev, names):
    model.train()
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
          if k != 'gt_masks'}
    losses = model.forward_train(tb['img'], tb['img_shapes'],
                                 tb['pad_shapes'], tb['gt_bboxes'],
                                 tb['gt_valid'], tb['gt_labels'])
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(sum(losses.values()),
                                [params[n] for n in names])
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: g.detach().cpu() for n, g in zip(names, grads)})


def _rp_train_errors(want, got):
    loss = {k: abs(got[0][k] - v) / max(abs(v), 1e-30)
            for k, v in want[0].items()}
    grad = {n: ((got[1][n] - g).abs().max() / g.abs().max()).item()
            for n, g in want[1].items()}
    return loss, grad


def reppoints_train_check(device='cuda', phase='reppoints-train-check',
                          names=REPPOINTS_TRAIN_GRADS,
                          limits=REPPOINTS_TRAIN_LIMITS):
    """Phase 7's check on RepPoints: forward_train in fp32 on phase 7's
    224x320 batch (4 gts an image), on the card (kernels) and on the CPU
    (plain versions), same seeded weights, no stochastic depth: the three
    losses and the gradients of ``names`` within ``limits`` (loss,
    gradient as max |d| over the largest entry), and a bf16 control on the
    card that must exceed both. The refined stage assigns by IoU on
    initial boxes the two devices compute apart: where the card's
    assignment differs from the CPU's, every difference must sit within
    REPPOINTS_IOU_NOISE of a threshold or of a gt's best IoU, and the
    card runs again reading the CPU's refined targets (pinned)."""
    opts = {'bf16': False, 'model.backbone.drop_path_rate': 0.0}
    start = time.perf_counter()
    cpu = init_detector(REPPOINTS_CONFIG, device='cpu', cfg_options=opts,
                        seed=1)
    gpu = _copy_model(cpu, 'float32', device)
    gpu = gpu.to(device)
    batch = train_check_batch()
    seen = []
    undo = _refine_targets(cpu, record=seen)
    try:
        ref = _rp_train_grads(cpu, batch, 'cpu', names)
    finally:
        undo()
    margin = _iou_margin(cpu, seen[1][0], batch)
    log(phase, f'models built and the CPU run in '
               f'{time.perf_counter() - start:.1f} s; refine stage: '
               f'nearest IoU to a threshold or a gt\'s best '
               f'{margin:.3g}')
    mine = []
    reset_launch_counts()
    undo = _refine_targets(gpu, record=mine)
    try:
        got = _rp_train_grads(gpu, batch, device, names)
    finally:
        undo()
    if device == 'cuda':
        _check_launches(phase, launch_counts(),
                        reppoints_launches(gpu, training=True), 1)
        _check_tc(phase, launch_counts(), False, _tc_kernels(False))
    if not all(torch.equal(a, b) for a, b in zip(seen[0][1], mine[0][1])):
        raise AssertionError('the initial stage\'s point assignment differs '
                             'between the card and the CPU')
    flips = sum(int((a != b).sum()) for a, b in zip(seen[1][1][:2],
                                                    mine[1][1][:2]))
    pinned = flips > 0
    if pinned:
        log(phase, f'the card\'s refined assignment differs from the CPU\'s '
                   f'in {flips} entries; pinned to the CPU\'s')
        if margin > REPPOINTS_IOU_NOISE:
            raise AssertionError('the refined assignments differ with no '
                                 'IoU within noise of a boundary')
        undo = _refine_targets(gpu, replay=seen[1])
        try:
            got = _rp_train_grads(gpu, batch, device, names)
        finally:
            undo()
    sound = _rp_train_errors(ref, got)
    ctl = _copy_model(cpu, 'bfloat16', device)
    undo = _refine_targets(ctl.to(device), replay=seen[1] if pinned
                           else None)
    try:
        control = _rp_train_errors(ref, _rp_train_grads(ctl, batch, device,
                                                         names))
    finally:
        undo()
    tol_loss, tol_grad = limits
    for what, (loss, grad) in (('fp32 card vs CPU', sound),
                               ('control, bf16 card vs fp32 CPU', control)):
        log(phase, f'224x320 {what}: relative loss |d| ' + ', '.join(
            f'{k} {v:.3g}' for k, v in loss.items()))
        log(phase, '  grad |d| / max: ' + ', '.join(
            f'{n} {v:.3g}' for n, v in grad.items()))
    over = [k for k, v in sound[0].items() if not v <= tol_loss] \
        + [n for n, v in sound[1].items() if not v <= tol_grad]
    if over:
        raise AssertionError(f'card vs CPU over the limits: {over}')
    if max(control[0].values()) <= tol_loss \
            or max(control[1].values()) <= tol_grad:
        raise AssertionError('the bf16 control passes the loss or the '
                             'gradient limit')
    return pinned


def reppoints_files(phase='reppoints-files'):
    """The config's own bbox-only train pipeline through train_detector
    for 2 iterations (2 PNGs of phase 10, one batch, whose batches must
    carry no gt_masks), then tools.test with the trained checkpoint on
    them, plain and with test-time augmentation (flip, two scales:
    aug_test_single_stage), --eval bbox, score_thr 0."""
    build_dir = os.path.join(REPO, 'build')
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        ann_file, prefix = write_synthetic_coco(root, REPPOINTS_LOOP_SIZES)
        work = os.path.join(root, 'work')
        cfg = loop_config(ann_file, prefix, work, max_epochs=2,
                          config=REPPOINTS_CONFIG)
        model_cfg = dict(cfg.model, dtype='bfloat16')
        model_cfg.pop('pretrained', None)
        model = build_detector(model_cfg)
        masks = []
        forward_train = model.forward_train

        def forward(*args, **kw):
            masks.append(args[6] if len(args) > 6 else kw.get('gt_masks'))
            return forward_train(*args, **kw)
        model.forward_train = forward
        reset_launch_counts()
        t0 = time.perf_counter()
        run = train_detector(model, build_dataset(cfg.data.train), cfg)
        torch.cuda.synchronize()
        launches = launch_counts()
        log(phase, f'train_detector: {len(run.log_vars)} iterations in '
                   f'{time.perf_counter() - t0:.1f} s, canvases '
                   f'{run.canvases}; loss '
                   + ', '.join(f'{v["loss"]:.4g}' for v in run.log_vars)
                   + '; grad_norm '
                   + ', '.join(f'{v["grad_norm"]:.4g}' for v in run.log_vars))
        bad = [v for v in run.log_vars
               if not all(np.isfinite(x) for x in v.values())]
        per = reppoints_launches(model, training=True)
        if len(run.log_vars) != 2 or bad or len(masks) != 2 \
                or any(m is not None for m in masks) \
                or launches != {k: 2 * v for k, v in per.items()}:
            raise AssertionError(f'the loop: {len(run.log_vars)} '
                                 f'iterations, non-finite {bad}, gt_masks '
                                 f'{[m is not None for m in masks]}, '
                                 f'launches {_nonzero(launches)}')
        log(phase, 'the batches carried no gt_masks; launches '
                   f'{_nonzero(launches)}, two steps\' worth')
        ckpt = os.path.join(work, 'epoch_2.pth')
        cfg_file = os.path.join(root, 'reppoints_cfg.py')
        eval_config(ann_file, prefix, config=REPPOINTS_CONFIG).dump(cfg_file)
        base = [cfg_file, ckpt, '--samples-per-gpu', '2', '--eval', 'bbox',
                '--cfg-options', 'bf16=True', 'model.test_cfg.score_thr=0.0']
        per = reppoints_launches(model, training=False)
        out = {}
        for what, n_aug, extra in (
                ('test', 1, []),
                ('TTA', 4, ['data.test.pipeline.1.img_'
                            f'scale={TTA_SCALES!r}',
                            'data.test.pipeline.1.flip=True'])):
            ran, launches, dets = _cli_run(phase, base + extra, what)
            want = {k: v * n_aug if k != 'nms_sorted' else v
                    for k, v in per.items()}
            if dets != [100, 100] or launches != want or not all(
                    np.isfinite(v) for v in ran['metrics'].values()
                    if isinstance(v, float)):
                raise AssertionError(f'{what}: detections {dets}, launches '
                                     f'{_nonzero(launches)} (expected '
                                     f'{_nonzero(want)}), metrics '
                                     f'{ran["metrics"]}')
            _check_tc(phase, launches, True, _tc_kernels(False, False))
            log(phase, f'{what}: metrics {dict(ran["metrics"])}')
            out[what] = launches
    return out


def phase_reppoints():
    """Phase 13: RepPoints-moment Swin-T serving, its fp32 serving check,
    training, its fp32 training check and the loop and test tool from
    files. Returns the serving and training results."""
    start = last = time.perf_counter()
    laps = []

    def lap(what):
        nonlocal last
        now = time.perf_counter()
        laps.append(f'{what} {now - last:.1f} s')
        log('time', f'reppoints: {laps[-1]}')
        last = now
    serve, lat = reppoints_serve()
    lap('serving')
    reppoints_check()
    lap('serving check')
    train, times, peak, busy, deform = reppoints_train()
    lap('training')
    pinned = reppoints_train_check()
    lap('training check')
    reppoints_files()
    lap('files')
    log('time', f'reppoints: ' + ', '.join(laps)
                + f'; phase 13 {time.perf_counter() - start:.1f} s')
    return dict(serve=serve, lat=lat, train=train, times=times, peak=peak,
                busy=busy, deform=deform, pinned=pinned)


# ------------------------------------------------------------- phase 14
FASTER_CONFIG = os.path.join(
    REPO, 'configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py')
RETINA_CONFIG = os.path.join(
    REPO, 'configs/retinanet/retinanet_r50_fpn_1x_coco.py')
RESNET_CONFIGS = {'faster': FASTER_CONFIG, 'retina': RETINA_CONFIG}
# the configs compute in fp32 as written; the phase serves and trains
# them in bf16, as the Swin configs compute
RESNET_BF16 = {'bf16': True}
# the frozen part of the configs' ResNet-50 (frozen_stages=1): the stem
# and layer1, which take no gradient
RESNET_FROZEN = ('backbone.conv1.', 'backbone.bn1.', 'backbone.layer1.')
# the gradients the fp32 training checks hold: a conv of each unfrozen
# stage's first and last block, a BN scale, the FPN and the heads
RESNET_BACKBONE_GRADS = (
    'backbone.layer2.0.conv1.weight',
    'backbone.layer3.5.conv2.weight',
    'backbone.layer4.2.conv3.weight',
    'backbone.layer4.2.bn3.weight')
FASTER_TRAIN_GRADS = RESNET_BACKBONE_GRADS + (
    'neck.lateral_convs.0.conv.weight',
    'neck.fpn_convs.0.conv.weight',
    'rpn_head.rpn_conv.weight',
    'roi_head.bbox_head.shared_fcs.0.weight',
    'roi_head.bbox_head.fc_cls.weight')
RETINA_TRAIN_GRADS = RESNET_BACKBONE_GRADS + (
    'neck.fpn_convs.0.conv.weight',
    'neck.fpn_convs.3.conv.weight',
    'bbox_head.cls_convs.0.conv.weight',
    'bbox_head.reg_convs.3.conv.weight',
    'bbox_head.retina_cls.weight',
    'bbox_head.retina_reg.weight')
# Limit of the fp32 card-vs-CPU training checks on the gradients that
# pass back through many ReLU units: the ResNet-50's (~25 M units at
# 224x320) and, in RetinaNet, those of the FPN output conv and the first
# tower conv behind its four ReLU tower convs (every anchor feeds the
# focal loss). A unit within fp32 rounding of zero passes its gradient on
# one side only. On an x86 CPU alone, noise of
# 1e-6 and 1e-5 of the input's largest entry moves layer2.0.conv1's
# gradient by 1.0e-3 and 2.8e-3 of its largest entry (Faster R-CNN's RPN
# group); noise of 5e-6 of the FPN features' largest entry, what the
# card's fp32 features differ from the CPU's by, moves RetinaNet's
# cls_convs.0 by 9.95e-3, fpn_convs.0 by 8.0e-4 and layer2.0.conv1 by
# 1.2e-3. The card read at most 2.84e-4 (Faster R-CNN) and 5.98e-3
# (RetinaNet's cls_convs.0) there, its bf16 controls 1.6e-2-3.3e-2 and
# 7.4e-2-0.16 (NVIDIA H100 80GB HBM3, 700.00 W). The
# limit is twice the CPU's own largest movement; every other gradient
# keeps phase 7's limit.
RESNET_GRAD_LIMIT = 2e-2
RELU_DEEP_GRADS = RESNET_BACKBONE_GRADS + (
    'neck.fpn_convs.0.conv.weight', 'bbox_head.cls_convs.0.conv.weight')
RESNET_TRAIN_LIMITS = ({}, dict(TOL_TRAIN_GRAD, **{
    n: RESNET_GRAD_LIMIT for n in RELU_DEEP_GRADS}))
# the loop's PNGs: 2 landscape images of phase 10's sizes, one batch
RESNET_LOOP_SIZES = LOOP_SIZES[:2]


def resnet_launches(model, training):
    """Each kernel's launches that one request (serving) or one step
    (training, the whole batch at once) of a ResNet-50 detector makes,
    derived from the built model: a conv3x3 launch per FPN output conv
    and, for Faster R-CNN, per RPN level (the shared RPN conv), for
    RetinaNet per tower conv on every level (in training one more each
    for dx and a filter-gradient launch each; the ResNet's convs, the
    FPN's laterals and stride-2 extra convs and RetinaNet's 3x3 output
    convs run F.conv2d, as the JAX package sends only stride-1, 3x3,
    128-multiple ConvModules to its kernel); Faster R-CNN's bbox RoIAlign
    once a request and once a step with its backward, its NMS twice a
    request (RPN, multiclass) and once a step (RPN); RetinaNet's NMS once
    a request (multiclass) and never in training."""
    convs = sum(c.use_kernel for c in model.neck.fpn_convs)
    two_stage = hasattr(model, 'rpn_head')
    if two_stage:
        convs += model.neck.num_outs * model.rpn_head.conv_uses_kernel
    else:
        head = model.bbox_head
        convs += len(head.prior_generator.strides) * sum(
            c.use_kernel for c in (*head.cls_convs, *head.reg_convs))
    want = {fn.__name__: 0 for fn in KERNEL_WRAPPERS}
    if training:
        want.update(conv3x3=2 * convs, conv3x3_dw=convs)
        if two_stage:
            want.update(roi_align=1, roi_align_bwd=1, nms_sorted=1)
    elif two_stage:
        want.update(conv3x3=convs, roi_align=1, nms_sorted=2)
    else:
        want.update(conv3x3=convs, nms_sorted=1)
    return want


def _resnet_model(which, device='cuda', seed=0, opts=RESNET_BF16):
    model = init_detector(RESNET_CONFIGS[which], device=device, seed=seed,
                          cfg_options=dict(opts))
    frozen = [n for n, _ in model.named_parameters()
              if n.startswith(RESNET_FROZEN)]
    if not frozen or type(model.backbone).__name__ != 'ResNet':
        raise AssertionError(f'{which}: not a ResNet with frozen stages')
    return model


def resnet_serve(which):
    """One ResNet-50 detector from its config in bf16 through
    init_detector and inference_detector: for RetinaNet the class output's
    bias shifted so that REPPOINTS_PAIRS (anchor, class) pairs of the
    warm-up request clear score_thr (the multiclass NMS cap full), a
    warm-up, then 3 requests at 800x1333 with every launch count
    checked."""
    phase = which
    t0 = time.perf_counter()
    model = _resnet_model(which)
    per = resnet_launches(model, training=False)
    log(phase, f'init_detector: {type(model).__name__} '
               f'{sum(p.numel() for p in model.parameters())} params, '
               f'compute {model.dtype}, {time.perf_counter() - t0:.1f} s; '
               f'launches per request {_nonzero(per)}')
    imgs = synthetic_images(3, seed=9)
    if which == 'retina':
        head = model.bbox_head
        thr = dict(model.test_cfg)['score_thr']
        # seeded weights score every pair at the 0.01 prior, under
        # score_thr: a uniform shift of the bias moves every logit alike
        logits = _candidate_logits(model, imgs[0])
        kth = torch.topk(logits.flatten(),
                         REPPOINTS_PAIRS).values[-1].item()
        shift = float(np.log(thr / (1 - thr))) - kth + 1e-3
        with torch.no_grad():
            head.retina_cls.bias.add_(shift)
        pairs = int((_candidate_logits(model, imgs[0]).sigmoid()
                     > thr).sum())
        log(phase, f'retina_cls bias {head.retina_cls.bias[0]:.4f} (prior '
                   f'{-np.log(99):.4f}, shifted by {shift:.4f}): {pairs} of '
                   f'{logits.numel()} candidate pairs of the warm-up '
                   f'request clear score_thr {thr}')
        if pairs < REPPOINTS_PAIRS // 2:
            raise AssertionError(f'{pairs} pairs clear score_thr: the NMS '
                                 f'cap of {REPPOINTS_PAIRS // 2} is not '
                                 f'full')
    t0 = time.perf_counter()
    _check_bbox_result(inference_detector(model, imgs[0]), 800, 1333)
    torch.cuda.synchronize()
    log(phase, f'warm-up request {time.perf_counter() - t0:.3f} s')
    reset_launch_counts()
    lat, counts = [], []
    for img in imgs:
        t0 = time.perf_counter()
        res = inference_detector(model, img)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        counts.append(_check_bbox_result(res, 800, 1333))
    launches = launch_counts()
    log(phase, 'per-request latency (s): '
               + ', '.join(f'{t:.4f}' for t in lat)
               + f'; detections per image: {counts}; {CARD}')
    if which == 'retina' and min(counts) < 100:
        raise AssertionError(f'detections {counts}: max_per_img 100 not '
                             f'reached with the cap full')
    _check_launches(phase, launches, per, len(imgs))
    tc = _check_tc(phase, launches, True, (conv3x3,))
    log(phase, f'kernel launches over the 3 requests {_nonzero(launches)}, '
               f'as derived; tensor-core {_nonzero(tc)}')
    return launches, lat


def _resnet_outputs(model, dev, img, shapes, sf):
    args = [torch.from_numpy(a).to(dev) for a in (img, shapes, sf)]
    with torch.inference_mode():
        feats = model.extract_feat(args[0])
        out = model.simple_test(*args)
    return ([f.cpu().float() for f in feats],
            {k: v.cpu() for k, v in out.items()}, None)


def _matched_errors(want, got):
    """_rp_errors with the detections of each image matched as sets, not
    slot by slot: a detection of ``want`` matches the one of ``got`` with
    its label and the nearest box (slots of two detections whose scores
    lie within fp32 noise may swap). None where the counts differ or a
    detection finds no box within 1 px."""
    (f_w, o_w, _), (f_g, o_g, _) = want, got
    feat_err = max((a - b).abs().max().item() / max(a.abs().max().item(), 1)
                   for a, b in zip(f_w, f_g))
    box_err = score_err = 0.0
    n = 0
    for i in range(o_w['dets'].shape[0]):
        vw, vg = o_w['det_valid'][i], o_g['det_valid'][i]
        if int(vw.sum()) != int(vg.sum()):
            return feat_err, None
        dw, lw = o_w['dets'][i][vw].double(), o_w['labels'][i][vw]
        dg, lg = o_g['dets'][i][vg].double(), o_g['labels'][i][vg]
        for d, lab in zip(dw, lw):
            dist = (dg[:, :4] - d[:4]).abs().amax(-1) \
                + torch.where(lg == lab, 0.0, torch.inf)
            j = int(dist.argmin()) if len(dist) else -1
            if j < 0 or not dist[j] <= 1.0:
                return feat_err, None
            box_err = max(box_err, dist[j].item())
            score_err = max(score_err, (dg[j, 4] - d[4]).abs().item())
            n += 1
    return feat_err, (box_err, score_err, n)


def resnet_check(which, device='cuda', phase=None, control=True):
    """Phase 5's check on a ResNet-50 detector: fp32 on a 224x320 canvas,
    the card (kernels) against the CPU (plain versions), same seeded
    weights, the class outputs set apart from every boundary (Faster
    R-CNN: rpn_cls and fc_cls spread as phase 5's; RetinaNet: retina_cls
    set by _set_class_logits, its margins logged); no tensor-core launch
    on the card; detections equal as sets (_matched_errors), features
    within 1e-3 of their largest entry, boxes within 1e-2 px, scores
    within 1e-2 (Faster R-CNN, phase 5's limit on its dets) or 1e-4
    (RetinaNet, phase 13's); a bf16 control that must exceed the
    limits."""
    phase = phase or f'{which}-check'
    cpu = _resnet_model(which, device='cpu', seed=1, opts={'bf16': False})
    rs = np.random.RandomState(1)
    img = rs.randn(1, 224, 320, 3).astype(np.float32)
    shapes = np.array([[224, 320]], np.int32)
    sf = np.ones((1, 4), np.float32)
    if which == 'faster':
        _spread_heads(cpu)
        score_limit = 1e-2
    else:
        # RetinaNet's top-1000 cuts fall among 10,080 and 2,520 anchors
        # whose best logits lie ~1e-4 apart (N(-16, 4^2) read 1.3e-4 at the
        # first on the card's machine's CPU, 8.0e-4 on another): a mean of
        # -19 puts every cut under score_thr, where a tie moves no
        # detection (the candidates are not compared)
        scale, bias, margins = _set_class_logits(
            cpu, torch.from_numpy(img), mean=-19.0,
            conv=cpu.bbox_head.retina_cls, candidates=False)
        log(phase, f'retina_cls weight x{scale:.4g}, bias {bias:.4g}: '
                   f'{margins[3]} candidate pairs clear score_thr; in '
                   f'logits, the nearest to score_thr\'s {margins[0]:.3g} '
                   f'away, the smallest gap at a level\'s top-k cut '
                   f'{margins[1]}, at the 2048-pair cap {margins[2]}')
        score_limit = 1e-4
    gpu = _copy_model(cpu, 'float32', device)
    gpu = gpu.to(device).eval()
    want = _resnet_outputs(cpu, 'cpu', img, shapes, sf)
    reset_launch_counts()
    got = _resnet_outputs(gpu, device, img, shapes, sf)
    if device == 'cuda':
        _check_tc(phase, launch_counts(), False, (conv3x3,))
    feat_err, errs = _matched_errors(want, got)
    if errs is None:
        raise AssertionError('detections differ between card and CPU')
    box_err, score_err, n = errs
    log(phase, f'224x320 fp32 card vs CPU: features rel max|d| '
               f'{feat_err:.3g}, {n} dets matched (label, nearest box), '
               f'box max|d| {box_err:.3g} px, score max|d| {score_err:.3g}; '
               f'slot by slot {_rp_errors(want, got)[1]}')
    if feat_err > 1e-3 or n == 0 or box_err > 1e-2 \
            or score_err > score_limit:
        raise AssertionError(f'card vs CPU over the limits: features 1e-3, '
                             f'boxes 1e-2 px, scores {score_limit}')
    if not control:
        return
    ctl = _copy_model(cpu, 'bfloat16', device)
    feat_err, errs = _matched_errors(want, _resnet_outputs(
        ctl.to(device).eval(), device, img, shapes, sf))
    log(phase, f'bf16 control vs the fp32 CPU run: features rel max|d| '
               f'{feat_err:.3g}, detections '
               + ('differ' if errs is None else
                  f'equal, box max|d| {errs[0]:.3g}, score max|d| '
                  f'{errs[1]:.3g}'))
    if errs is not None and feat_err <= 1e-3 and errs[0] <= 1e-2 \
            and errs[1] <= score_limit:
        raise AssertionError('the bf16 control passes the fp32 limits')


# names of the library's convolution and GEMM kernels (cuDNN's, cuBLAS's):
# the ResNet's 3x3 and strided convs run cuDNN, its 1x1 convs, the FPN's
# laterals and the heads' FCs run F.linear
LIBRARY_MATMUL_KEYS = ('conv', 'fprop', 'dgrad', 'wgrad', 'xmma', 'cudnn',
                       'gemm', 'cutlass', 'nvjet', 'sm90_')


def _conv_split(rows, phase):
    """A profile's kernel ms a step in the hand-written kernels and in the
    library's convolutions and GEMMs (logged, the five longest by name)."""
    ours = sum(ms for key, ms, _ in rows if 'swindet' in key)
    lib = [r for r in rows if 'swindet' not in r[0] and any(
        w in r[0].lower() for w in LIBRARY_MATMUL_KEYS)]
    for key, ms, count in lib[:5]:
        log(phase, f'  library: {ms:9.3f} ms/step  {count:5d} launches/step'
                   f'  {key[:100]}')
    return ours, sum(r[1] for r in lib)


def resnet_train(which):
    """1 + 5 make_train_step steps of a ResNet-50 detector (its config in
    bf16: SGD with momentum and weight decay, the step schedule's linear
    warm-up) at batch 2 on the 800x1344 canvas with 16 painted rectangles
    an image and no gt_masks, each step's launches checked; the frozen
    BN's buffers unmoved by the steps and the frozen stages' parameters
    given a zero gradient; 2 profiled steps, with the kernel ms split
    between the hand-written kernels and the library's convolutions and
    GEMMs."""
    phase = f'{which}-train'
    cfg = Config.fromfile(RESNET_CONFIGS[which])
    cfg.merge_from_dict(RESNET_BF16)
    model = _resnet_model(which)
    opt = build_optimizer(model, dict(cfg.optimizer))
    if not isinstance(opt, torch.optim.SGD):
        raise AssertionError(f'{which}: optimizer {type(opt).__name__}')
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH)
    step = make_train_step(model, opt, schedule,
                           dict(cfg.optimizer_config).get('grad_clip'))
    per = resnet_launches(model, training=True)
    batch = synthetic_train_batch()
    del batch['gt_masks']
    gen = torch.Generator(device='cuda').manual_seed(0)
    stats = {k: v.clone() for k, v in model.named_buffers()}
    t0 = time.perf_counter()
    _check_log(step(batch, gen), 'warm-up step')
    torch.cuda.synchronize()
    log(phase, f'warm-up step {time.perf_counter() - t0:.3f} s; '
               f'{cfg.optimizer["type"]} lr {cfg.optimizer["lr"]} momentum '
               f'{cfg.optimizer["momentum"]}; launches per step '
               f'{_nonzero(per)}')
    frozen = {n: p for n, p in model.named_parameters()
              if n.startswith(RESNET_FROZEN)}
    if any(p.grad is None or p.grad.any() for p in frozen.values()):
        raise AssertionError('the frozen stages\' parameters hold no zero '
                             'gradient after a step')
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_log(out, 'timed step')
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(phase, 'per-step ms: ' + ', '.join(f'{t:.1f}' for t in times)
               + f'; median {np.median(times):.1f}; peak memory '
                 f'{peak / 2 ** 30:.2f} GiB; {CARD}')
    log(phase, 'last step: ' + ', '.join(f'{k} {v:.4f}'
                                         for k, v in out.items()))
    _check_launches(phase, launches, per, 5)
    tc = _check_tc(phase, launches, True, (conv3x3, conv3x3_dw))
    log(phase, f'kernel launches over the 5 timed steps {_nonzero(launches)}'
               f', as derived; tensor-core {_nonzero(tc)}')
    moved = [k for k, v in model.named_buffers() if not torch.equal(
        v, stats[k])]
    if moved:
        raise AssertionError(f'frozen BN buffers moved in training: '
                             f'{moved[:4]}')
    rows = []
    busy = _profile_steps(step, batch, gen, float(np.median(times)), phase,
                          rows_out=rows)
    ours, lib = _conv_split(rows, phase)
    kernel_ms = sum(r[1] for r in rows)
    log(phase, f'median step {np.median(times):.1f} ms, busy {busy:.3f}, '
               f'peak {peak / 2 ** 30:.2f} GiB; kernel {kernel_ms:.1f} ms a '
               f'step: hand-written {ours:.2f} ms, library convolutions and '
               f'GEMMs {lib:.2f} ms; BN buffers unmoved; on {CARD}')
    return launches, times, peak, busy, (kernel_ms, ours, lib)


def resnet_train_check(which, device='cuda'):
    """Phase 7's check on a ResNet-50 detector, fp32 on phase 7's 224x320
    batch, the card (kernels) against the CPU (plain versions), same
    seeded weights and batch, with a bf16 control on the card that must
    exceed the limits. Faster R-CNN goes through phase_train_check (the
    RPN and bbox groups, same sampler keys, the card reading the CPU's RPN
    outputs, the chain checked apart unpinned, as phase 12's; the ResNet's
    gradients at RESNET_GRAD_LIMIT, the rest at phase 7's limits);
    RetinaNet
    (a PseudoSampler over fixed anchors: nothing to pin) as phase 13's,
    its two losses at TOL_TRAIN_LOSS and the gradients of
    RETINA_TRAIN_GRADS at phase 7's RPN-group limit, those of
    RELU_DEEP_GRADS at RESNET_GRAD_LIMIT (RESNET_TRAIN_LIMITS); the ReLU
    units of the ResNet and the head's towers that differ between the two
    runs counted."""
    if which == 'faster':
        phase_train_check(device=device, config=FASTER_CONFIG,
                          names=FASTER_TRAIN_GRADS, pin_proposals=True,
                          limits=RESNET_TRAIN_LIMITS,
                          opts=(('bf16', False),))
        return
    phase = 'retina-train-check'
    cpu = _resnet_model(which, device='cpu', seed=1, opts={'bf16': False})
    gpu = _copy_model(cpu, 'float32', device)
    gpu = gpu.to(device)
    batch = train_check_batch()
    relus, towers = ([], []), ([], [])

    def record(model, i):
        def keep(mod, args, out):
            towers[i].append((out > 0).flatten().cpu())
        head = model.bbox_head
        return _backbone_relus(model, relus[i]) + [
            c.register_forward_hook(keep)
            for c in (*head.cls_convs, *head.reg_convs)]
    t0 = time.perf_counter()
    hooks = record(cpu, 0)
    ref = _rp_train_grads(cpu, batch, 'cpu', RETINA_TRAIN_GRADS)
    log(phase, f'the CPU run {time.perf_counter() - t0:.1f} s; losses '
               + ', '.join(f'{k} {v:.5g}' for k, v in ref[0].items()))
    reset_launch_counts()
    hooks += record(gpu, 1)
    sound = _rp_train_errors(ref, _rp_train_grads(gpu, batch, device,
                                                  RETINA_TRAIN_GRADS))
    for h in hooks:
        h.remove()
    flips = [int((torch.cat(a) != torch.cat(b)).sum())
             for a, b in (relus, towers)]
    log(phase, f'ReLU units that differ between the card and the CPU: '
               f'ResNet {flips[0]} of {torch.cat(relus[0]).numel()}, head '
               f'towers {flips[1]} of {torch.cat(towers[0]).numel()}')
    if device == 'cuda':
        _check_launches(phase, launch_counts(),
                        resnet_launches(gpu, training=True), 1)
        _check_tc(phase, launch_counts(), False, (conv3x3, conv3x3_dw))
    ctl = _copy_model(cpu, 'bfloat16', device)
    control = _rp_train_errors(ref, _rp_train_grads(
        ctl.to(device), batch, device, RETINA_TRAIN_GRADS))
    for what, (loss, grad) in (('fp32 card vs CPU', sound),
                               ('control, bf16 card vs fp32 CPU', control)):
        log(phase, f'224x320 {what}: relative loss |d| ' + ', '.join(
            f'{k} {v:.3g}' for k, v in loss.items()))
        log(phase, '  grad |d| / max: ' + ', '.join(
            f'{n} {v:.3g}' for n, v in grad.items()))
    tol_grad = RESNET_TRAIN_LIMITS[1]

    def over(errs):
        return [k for k, v in errs[0].items() if not v <= TOL_TRAIN_LOSS] \
            + [n for n, v in errs[1].items()
               if not v <= tol_grad.get(n, tol_grad['rpn'])]
    if over(sound):
        raise AssertionError(f'card vs CPU over the limits: {over(sound)}')
    if not any(k in over(control) for k in control[0]) \
            or not any(n in over(control) for n in control[1]):
        raise AssertionError('the bf16 control passes the loss or the '
                             'gradient limits')


def resnet_files(which):
    """From files: for Faster R-CNN train_detector for one epoch on 2 of
    phase 10's PNGs with the config's own bbox-only pipeline (one
    iteration, no gt_masks), then a second epoch resumed from
    epoch_1.pth; for both, tools.test on the 2 PNGs with a checkpoint
    (Faster R-CNN's trained one, RetinaNet's seeded), --eval bbox,
    score_thr 0: 100 detections an image."""
    phase = f'{which}-files'
    build_dir = os.path.join(REPO, 'build')
    os.makedirs(build_dir, exist_ok=True)
    config = RESNET_CONFIGS[which]
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        ann_file, prefix = write_synthetic_coco(root, RESNET_LOOP_SIZES)
        work = os.path.join(root, 'work')
        if which == 'faster':
            cfg = loop_config(ann_file, prefix, work, config=config)
            model_cfg = dict(cfg.model, dtype='bfloat16')
            model_cfg.pop('pretrained', None)
            dataset = build_dataset(cfg.data.train)
            for epochs in (1, 2):
                cfg = loop_config(ann_file, prefix, work, max_epochs=epochs,
                                  config=config)
                # seeded weights: torchvision://resnet50 needs a download
                cfg.model.pretrained = None
                if epochs == 2:
                    cfg.resume_from = os.path.join(work, 'epoch_1.pth')
                model = build_detector(model_cfg)
                per = resnet_launches(model, training=True)
                reset_launch_counts()
                t0 = time.perf_counter()
                run = train_detector(model, dataset, cfg)
                torch.cuda.synchronize()
                launches = launch_counts()
                log(phase, f'train_detector, epoch {epochs}'
                           f'{" resumed" if epochs == 2 else ""}: '
                           f'{len(run.log_vars)} iterations in '
                           f'{time.perf_counter() - t0:.1f} s, canvases '
                           f'{run.canvases}; loss ' + ', '.join(
                               f'{v["loss"]:.4g}' for v in run.log_vars)
                           + '; grad_norm ' + ', '.join(
                               f'{v["grad_norm"]:.4g}'
                               for v in run.log_vars))
                bad = [v for v in run.log_vars
                       if not all(np.isfinite(x) for x in v.values())]
                if len(run.log_vars) != 1 or bad or run.epoch != epochs \
                        or launches != per:
                    raise AssertionError(
                        f'epoch {epochs}: {len(run.log_vars)} iterations, '
                        f'epoch {run.epoch}, non-finite {bad}, launches '
                        f'{_nonzero(launches)} (expected {_nonzero(per)})')
            ckpt = os.path.join(work, 'epoch_2.pth')
            opts = ['model.test_cfg.rcnn.score_thr=0.0']
        else:
            ckpt = os.path.join(root, 'retina.pth')
            model = _resnet_model(which, device='cpu')
            save_checkpoint(ckpt, model,
                            meta=dict(CLASSES=list(COCO_CLASSES)))
            opts = ['model.test_cfg.score_thr=0.0']
        cfg_file = os.path.join(root, f'{which}_cfg.py')
        eval_config(ann_file, prefix, config=config).dump(cfg_file)
        ran, launches, dets = _cli_run(phase, [
            cfg_file, ckpt, '--samples-per-gpu', '2', '--eval', 'bbox',
            '--cfg-options', 'bf16=True', *opts], 'test')
        want = resnet_launches(model, training=False)
        if dets != [100, 100] or launches != want or not all(
                np.isfinite(v) for v in ran['metrics'].values()
                if isinstance(v, float)):
            raise AssertionError(f'test: detections {dets}, launches '
                                 f'{_nonzero(launches)} (expected '
                                 f'{_nonzero(want)}), metrics '
                                 f'{ran["metrics"]}')
        _check_tc(phase, launches, True, (conv3x3,))
        log(phase, f'test: metrics {dict(ran["metrics"])}')
        return launches


def phase_resnet():
    """Phase 14: Faster R-CNN R-50 and RetinaNet R-50, each serving, its
    fp32 serving check, training, its fp32 training check and the test
    tool from files (Faster R-CNN also train_detector, resumed). Returns
    each model's serving and training results."""
    start = last = time.perf_counter()
    laps = []

    def lap(what):
        nonlocal last
        now = time.perf_counter()
        laps.append(f'{what} {now - last:.1f} s')
        log('time', f'resnet: {laps[-1]}')
        last = now
    out = {}
    for which in RESNET_CONFIGS:
        serve, lat = resnet_serve(which)
        lap(f'{which} serving')
        resnet_check(which)
        lap(f'{which} serving check')
        train, times, peak, busy, split = resnet_train(which)
        lap(f'{which} training')
        resnet_train_check(which)
        lap(f'{which} training check')
        resnet_files(which)
        lap(f'{which} files')
        out[which] = dict(serve=serve, lat=lat, train=train, times=times,
                          peak=peak, busy=busy, split=split)
    log('time', f'resnet: ' + ', '.join(laps)
                + f'; phase 14 {time.perf_counter() - start:.1f} s')
    return out


# ------------------------------------------------------------ phase 15
# the ResNet zoo's variants: DCNv2 / DCN bottlenecks, GN + ConvWS, the C4
# shared head, DC5, modulated deformable RoI pooling and the cascade
ZOO_CONFIGS = {
    'mdconv': 'configs/dcn/mask_rcnn_r50_fpn_mdconv_c3-c5_1x_coco.py',
    'dconv': 'configs/dcn/faster_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py',
    'gn_ws': 'configs/gn+ws/mask_rcnn_r50_fpn_gn_ws-all_2x_coco.py',
    'c4': 'configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py',
    'dc5': 'configs/faster_rcnn/faster_rcnn_r50_caffe_dc5_1x_coco.py',
    'mdpool': 'configs/dcn/faster_rcnn_r50_fpn_mdpool_1x_coco.py',
    'cascade_r50': 'configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py',
}
ZOO_CONFIGS = {k: os.path.join(REPO, v) for k, v in ZOO_CONFIGS.items()}
ZOO_TRAINED = ('mdconv', 'gn_ws', 'c4', 'mdpool')
# the gradients the fp32 training checks hold: a conv of each unfrozen
# stage (a deformable conv2 and its offset conv where there is one), a
# norm scale, the neck, the RPN conv and the heads; the backbone's sit
# behind the ReLU path (RESNET_GRAD_LIMIT)
ZOO_BACKBONE_GRADS = {
    'mdconv': ('backbone.layer2.0.conv1.weight',
               'backbone.layer3.5.conv2.weight',
               'backbone.layer3.5.conv2.conv_offset.weight',
               'backbone.layer4.2.bn3.weight'),
    'gn_ws': ('backbone.layer2.0.conv1.weight',
              'backbone.layer3.5.conv2.weight',
              'backbone.layer4.2.gn3.weight'),
    'c4': ('backbone.layer2.0.conv1.weight', 'backbone.layer3.5.conv2.weight',
           'backbone.layer3.5.bn3.weight'),
    'mdpool': RESNET_BACKBONE_GRADS,
}
ZOO_HEAD_GRADS = {
    'mdconv': ('neck.fpn_convs.0.conv.weight', 'rpn_head.rpn_conv.weight',
               'roi_head.bbox_head.shared_fcs.0.weight',
               'roi_head.bbox_head.fc_cls.weight',
               'roi_head.mask_head.convs.0.conv.weight'),
    'gn_ws': ('neck.fpn_convs.0.conv.weight', 'neck.fpn_convs.0.gn.weight',
              'rpn_head.rpn_conv.weight',
              'roi_head.bbox_head.shared_convs.0.conv.weight',
              'roi_head.bbox_head.fc_cls.weight',
              'roi_head.mask_head.convs.0.conv.weight'),
    'c4': ('rpn_head.rpn_conv.weight',
           'roi_head.shared_head.layer4.0.conv1.weight',
           'roi_head.shared_head.layer4.2.conv3.weight',
           'roi_head.bbox_head.fc_cls.weight',
           'roi_head.mask_head.upsample.weight'),
    'mdpool': ('neck.fpn_convs.0.conv.weight', 'rpn_head.rpn_conv.weight',
               'roi_head.bbox_roi_extractor.roi_layers.0.offset_fc.4.weight',
               'roi_head.bbox_roi_extractor.roi_layers.1.mask_fc.2.weight',
               'roi_head.bbox_head.shared_fcs.0.weight',
               'roi_head.bbox_head.fc_cls.weight'),
}
# gn_ws's training-check limits. Its seeded GN + ConvWS ResNet-50's
# zero-mean filters cancel most of their (post-ReLU) input, so the card's
# fp32 rounding reaches 7.3e-6 in the RPN losses, 0.19 in the backbone's
# gradients, 0.034 in the neck's and heads', 3.8e-4 in the RPN outputs,
# and leaves 0.7575 of the unpinned proposals within TOL_PROPOSAL_PX (the
# same readings in each of four runs; NVIDIA H100 80GB HBM3, 700.00 W);
# cut to two or three stages the detector carries it as far
# (PERF.md). Each limit is 2-3 times the card's reading and under the bf16
# control's (losses 0.019-0.058, backbone 0.435-1.34, neck and heads
# 0.5-1.16, RPN outputs 0.54); fc_cls (4.0e-5) keeps phase 7's limit
ZOO_TRAIN_LIMITS = {'gn_ws': dict(
    limits=({k: 2e-5 for k in ('loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls')},
            {'rpn': 0.1, 'bbox': 0.1, 'mask': 0.1,
             'roi_head.bbox_head.fc_cls.weight': TOL_TRAIN_GRAD['bbox'],
             **{n: 0.4 for n in ZOO_BACKBONE_GRADS['gn_ws']}}),
    rpn_tol=1e-3, min_share=0.5)}
# The cut of the fp32 training checks of phases 15 and 16, whose CPU side
# runs the RoI head's backward on every sampled roi (the plain RoIAlign
# backward, C4's res5, the plain deformable RoI pooling; c4's check took
# 21.1 s and mdpool's 16.8 s of phase 15's 166.8 s): CHECK_ROIS rois an
# image where the configs sample 512, the proposals pinned. The serving
# checks keep the configs' 1,000 proposals: a cap of 300 cuts the RPN's
# NMS output among near-tied scores, and mdconv's card and CPU detections
# parted there. gn_ws keeps its sizes, at which its fixed limits were
# read; the cascade serves only
CHECK_ROI_CUT = {'model.train_cfg.rcnn.sampler.num': CHECK_ROIS}
ZOO_CHECK_CUTS = {'gn_ws': {}, 'cascade_r50': {}}
# requests a config serves, steps a config trains (after a warm-up each)
ZOO_REQUESTS = 2
ZOO_STEPS = 3


def zoo_launches(model, training):
    """Each kernel's launches that one request (serving) or one step
    (training) of a zoo detector makes, derived from the built model: a
    conv3x3 launch per kernel ConvModule of the neck and of the mask head
    and per RPN level of a kernel RPN conv (in training one more each for
    dx and a filter-gradient launch each); a RoIAlign launch per bbox
    extractor call (a cascade's three stages; a deformable extractor's
    first pass) and per mask extractor call, in training each with its
    backward; the NMS twice a request and once a step."""
    convs = model.rpn_head.conv_uses_kernel \
        * len(model.rpn_head.prior_generator.strides)
    if model.neck is not None:
        convs += sum(c.use_kernel for c in model.neck.fpn_convs)
    roi = model.roi_head
    for head in _heads(roi.mask_head):
        convs += sum(c.use_kernel for c in head.convs)
    for head in _heads(roi.bbox_head):
        convs += sum(c.use_kernel for c in head.shared_convs)
    aligns = getattr(roi, 'num_stages', 1) + (roi.mask_head is not None)
    want = {fn.__name__: 0 for fn in KERNEL_WRAPPERS}
    if training:
        want.update(conv3x3=2 * convs, conv3x3_dw=convs, roi_align=aligns,
                    roi_align_bwd=aligns, nms_sorted=1)
    else:
        want.update(conv3x3=convs, roi_align=aligns, nms_sorted=2)
    return want


def _zoo_model(name, device='cuda', seed=0, opts=RESNET_BF16):
    """A config of phase 15 or 16 through init_detector, its backbone of
    the type the config names."""
    model = init_detector(ZOO_ALL[name], device=device, seed=seed,
                          cfg_options=dict(opts))
    want = BACKBONE_TYPES.get(name, 'ResNet')
    if type(model.backbone).__name__ != want:
        raise AssertionError(f'{name}: not a {want} detector')
    return model


def zoo_serve(name):
    """One zoo detector from its config in bf16 through init_detector and
    inference_detector: a warm-up, then ZOO_REQUESTS requests at 800x1333
    with every launch count checked."""
    phase = f'zoo-{name}'
    t0 = time.perf_counter()
    model = _zoo_model(name)
    per = zoo_launches(model, training=False)
    log(phase, f'init_detector: {type(model).__name__} '
               f'{sum(p.numel() for p in model.parameters())} params, '
               f'compute {model.dtype}, {time.perf_counter() - t0:.1f} s; '
               f'launches per request {_nonzero(per)}')
    # masks come in the image's 800x1333 frame; the test pipeline pads it
    # to 800x1344, and the boxes are clipped to that shape, as in the JAX
    # package
    if model.roi_head.with_mask:
        def check(res):
            return _check_result(res, 800, 1333)
    else:
        def check(res):
            return _check_bbox_result(res, 800, 1344)
    imgs = synthetic_images(ZOO_REQUESTS + 1, seed=9)
    t0 = time.perf_counter()
    check(inference_detector(model, imgs[0]))
    torch.cuda.synchronize()
    log(phase, f'warm-up request {time.perf_counter() - t0:.3f} s')
    reset_launch_counts()
    lat, counts = [], []
    for img in imgs[1:]:
        t0 = time.perf_counter()
        res = inference_detector(model, img)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        counts.append(check(res))
    launches = launch_counts()
    _check_launches(phase, launches, per, ZOO_REQUESTS)
    tc = _check_tc(phase, launches, True, (conv3x3,))
    log(phase, 'per-request latency (s): '
               + ', '.join(f'{t:.4f}' for t in lat)
               + f'; detections per image: {counts}; launches '
                 f'{_nonzero(launches)}, as derived; tensor-core '
                 f'{_nonzero(tc)}; {CARD}')
    return launches, lat


def zoo_check(name, device='cuda', control=True):
    """Phase 14's serving check on a zoo detector: fp32 on a 224x320
    canvas, the card (kernels) against the CPU (plain versions), same
    seeded weights with rpn_cls and every fc_cls spread as phase 5's; no
    tensor-core launch on the card; detections equal as sets
    (_matched_errors), features within 1e-3 of their largest entry, boxes
    within 1e-2 px, scores within 1e-2; a bf16 control that must exceed
    the limits. The model is _zoo_check_model's: a plugin's zero-init
    parameters drawn, HRNet's neck scaled. Returns the CPU model, for
    zoo_train_check."""
    phase = f'zoo-{name}-check'
    cpu = _zoo_check_model(name)
    img, shapes, sf = _zoo_check_inputs()
    gpu = _copy_model(cpu, 'float32', device)
    gpu = gpu.to(device).eval()
    want = _resnet_outputs(cpu, 'cpu', img, shapes, sf)
    reset_launch_counts()
    got = _resnet_outputs(gpu, device, img, shapes, sf)
    if device == 'cuda':
        _check_tc(phase, launch_counts(), False, (conv3x3,))
    feat_err, errs = _matched_errors(want, got)
    if errs is None:
        raise AssertionError(f'{name}: detections differ between card and '
                             f'CPU')
    box_err, score_err, n = errs
    log(phase, f'224x320 fp32 card vs CPU: features rel max|d| '
               f'{feat_err:.3g}, {n} dets matched, box max|d| {box_err:.3g}'
               f' px, score max|d| {score_err:.3g}')
    if feat_err > 1e-3 or n == 0 or box_err > 1e-2 or score_err > 1e-2:
        raise AssertionError(f'{name}: card vs CPU over the limits: '
                             f'features 1e-3, boxes 1e-2 px, scores 1e-2')
    if not control:
        return
    ctl = _copy_model(cpu, 'bfloat16', device)
    feat_err, errs = _matched_errors(want, _resnet_outputs(
        ctl.to(device).eval(), device, img, shapes, sf))
    log(phase, f'bf16 control vs the fp32 CPU run: features rel max|d| '
               f'{feat_err:.3g}, detections '
               + ('differ' if errs is None else
                  f'equal, box max|d| {errs[0]:.3g}, score max|d| '
                  f'{errs[1]:.3g}'))
    if errs is not None and feat_err <= 1e-3 and errs[0] <= 1e-2 \
            and errs[1] <= 1e-2:
        raise AssertionError(f'{name}: the bf16 control passes the fp32 '
                             f'limits')
    return cpu


def _zoo_check_inputs():
    """zoo_check's 224x320 image, its shape and scale factors."""
    rs = np.random.RandomState(1)
    return (rs.randn(1, 224, 320, 3).astype(np.float32),
            np.array([[224, 320]], np.int32), np.ones((1, 4), np.float32))


def _zoo_check_model(name):
    """The CPU model of a zoo config's fp32 checks: seed 1, cut to
    CHECK_ROI_CUT (ZOO_CHECK_CUTS where it says otherwise), rpn_cls and fc_cls spread
    (_spread_heads), the plugins drawn (_draw_plugins) and, for HRNet, the
    neck scaled (_unit_neck)."""
    cuts = ZOO_CHECK_CUTS.get(name, CHECK_ROI_CUT)
    cpu = _zoo_model(name, device='cpu', seed=1, opts={'bf16': False, **cuts})
    _spread_heads(cpu)
    _draw_plugins(cpu)
    if BACKBONE_TYPES.get(name) == 'HRNet':
        _unit_neck(cpu, _zoo_check_inputs()[0])
    return cpu


def _unit_neck(model, img):
    """Scale HRFPN's reduction conv so that the neck's first level has a
    std of 1 on ``img``. The seeded HRNet's fuse sums grow its features
    to a std of ~1,000 (frozen BN at statistics 0 and 1), and its boxes
    regress off the image: 18 of its 20 detections on the check image are
    slivers at a border, and fp32 noise of 1e-7 in the input moves them
    by up to 0.144 px on the CPU alone; scaled, 100 detections, moved by
    4.9e-4 px."""
    with torch.no_grad():
        std = float(model.extract_feat(torch.from_numpy(img))[0].std())
        conv = model.neck.reduction_conv.conv
        conv.weight.div_(std)
        conv.bias.div_(std)


def _unit_neck_checkpoint(cfg, root):
    """A checkpoint in ``root`` of the config's seeded weights (cfg.seed)
    with the neck scaled by _unit_neck on zoo_check's image, for
    train_detector to load over its own seeded init (``load_from``). One
    SGD step from the seeded HRNet as it is (features of std ~1,000: loss
    747.6, gradient norm 53,133 at 800x1344) leaves tools.test no
    detection at score_thr 0."""
    model = build_detector(dict(cfg.model))
    model.init_weights(cfg.seed)
    _unit_neck(model.eval(), _zoo_check_inputs()[0])
    path = os.path.join(root, 'seeded_unit_neck.pth')
    save_checkpoint(path, model)
    return path


def _draw_plugins(model, seed=3):
    """Draw the zero-init parameters of the backbone's plugins from a
    seeded generator: each ContextBlock transform's last conv
    (lecun-normal, as its first) and each GeneralizedAttention's
    ``gamma`` (N(0, 1)). At init a plugin is the identity and its inner
    convs take no gradient, so a check would pass whatever its body
    computes. Both sides of a check load the drawn CPU model's weights."""
    from swindet_tpu_torch.models.layers import init_conv
    from swindet_tpu_torch.ops.plugins import (ContextBlock,
                                               GeneralizedAttention)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.backbone.modules():
            if isinstance(m, ContextBlock):
                for seq in (m.channel_add_conv, m.channel_mul_conv):
                    if seq is not None:
                        init_conv(seq[3], gen)
            elif isinstance(m, GeneralizedAttention):
                m.gamma.copy_(torch.randn(1, generator=gen))


def _deform_ops_ms(model, batch, phase):
    """CUDA-event ms of the plain deformable ops of one training step,
    forward and backward together (_module_ms of each deformable conv2 or
    ConvModule pack and each deformable RoI extractor)."""
    from swindet_tpu_torch.models.roi_heads.roi_extractor import \
        DeformRoIExtractor
    from swindet_tpu_torch.ops.deform_conv import ModulatedDeformConvPack
    return _module_ms(model, batch, phase, 'deformable ops',
                      (ModulatedDeformConvPack, DeformRoIExtractor))


def _plugin_ms(model, batch, phase):
    """_module_ms of the backbone's plugins (ContextBlock,
    GeneralizedAttention)."""
    from swindet_tpu_torch.ops.plugins import PLUGIN_TYPES
    return _module_ms(model, batch, phase, 'plugins',
                      tuple(PLUGIN_TYPES.values()))


def _module_ms(model, batch, phase, what, kinds):
    """CUDA-event ms of the modules of ``kinds`` in one training step,
    forward and backward together: each runs again, with gradients, on
    the inputs a training forward of ``batch`` gave it; and the device
    time of their kernels in one more such run (torch.profiler)."""
    calls = []

    def keep(mod, args):
        calls.append((mod, [a.detach().clone() if torch.is_tensor(a)
                            else [t.detach().clone() for t in a]
                            for a in args]))
    hooks = [m.register_forward_pre_hook(keep) for m in model.modules()
             if isinstance(m, kinds)]
    if not hooks:
        return 0.0, 0.0
    try:
        model.train()
        with torch.no_grad():
            model.forward_train(batch['img'], batch['img_shapes'],
                                batch['pad_shapes'], batch['gt_bboxes'],
                                batch['gt_valid'], batch['gt_labels'],
                                batch.get('gt_masks'),
                                gen=torch.Generator(device='cuda')
                                .manual_seed(1))
    finally:
        for h in hooks:
            h.remove()
    from torch.profiler import ProfilerActivity, profile
    runs = []
    for mod, args in calls:
        feats = args[0] if isinstance(args[0], list) else [args[0]]
        for f in feats:
            f.requires_grad_(True)

        def run(mod=mod, args=args, feats=feats):
            out = mod(*args)
            # the extractor reads the first 4 of the 5 FPN levels
            torch.autograd.grad(out.float().sum(),
                                feats + list(mod.parameters()),
                                allow_unused=True)
        runs.append(run)
    total = sum(cuda_ms(run, warmup=1, iters=2) for run in runs)
    # the same calls once more under the profiler: their kernels' device
    # time, against which the events' time shows what the host adds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for run in runs:
            run()
        torch.cuda.synchronize()
    device = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, 'is_user_annotation', False)) / 1e3
    log(phase, f'{what}: {len(calls)} calls a step, forward and '
               f'backward {total:.2f} ms (CUDA events, each call alone), '
               f'of which kernels {device:.2f} ms (torch.profiler)')
    return total, device


def zoo_train(name):
    """1 + ZOO_STEPS make_train_step steps of a zoo detector (its config
    in bf16, SGD with momentum and weight decay) at batch 2 on the
    800x1344 canvas, each step's launches checked; frozen BN buffers
    unmoved; a profiled step (busy share), the deformable ops' ms and the
    plugins' ms."""
    phase = f'zoo-{name}-train'
    cfg = Config.fromfile(ZOO_ALL[name])
    cfg.merge_from_dict(RESNET_BF16)
    model = _zoo_model(name)
    opt = build_optimizer(model, dict(cfg.optimizer))
    if not isinstance(opt, torch.optim.SGD):
        raise AssertionError(f'{name}: optimizer {type(opt).__name__}')
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH)
    step = make_train_step(model, opt, schedule,
                           dict(cfg.optimizer_config).get('grad_clip'))
    per = zoo_launches(model, training=True)
    batch = synthetic_train_batch()
    if not model.roi_head.with_mask:
        del batch['gt_masks']
    gen = torch.Generator(device='cuda').manual_seed(0)
    stats = {k: v.clone() for k, v in model.named_buffers()}
    t0 = time.perf_counter()
    _check_log(step(batch, gen), 'warm-up step')
    torch.cuda.synchronize()
    log(phase, f'warm-up step {time.perf_counter() - t0:.3f} s; launches '
               f'per step {_nonzero(per)}')
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(ZOO_STEPS):
        t0 = time.perf_counter()
        out = step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_log(out, 'timed step')
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_launches(phase, launches, per, ZOO_STEPS)
    tc = _check_tc(phase, launches, True, (conv3x3, conv3x3_dw))
    moved = [k for k, v in model.named_buffers()
             if not torch.equal(v, stats[k])]
    if moved:
        raise AssertionError(f'{name}: frozen BN buffers moved: {moved[:4]}')
    log(phase, 'per-step ms: ' + ', '.join(f'{t:.1f}' for t in times)
               + f'; peak memory {peak / 2 ** 30:.2f} GiB; last step: '
               + ', '.join(f'{k} {v:.4f}' for k, v in out.items())
               + f'; launches {_nonzero(launches)}, as derived; '
                 f'tensor-core {_nonzero(tc)}; {CARD}')
    busy = _profile_steps(step, batch, gen, float(np.median(times)), phase,
                          n=1)
    deform_ms, _ = _deform_ops_ms(model, batch, phase)
    plugin_ms = _plugin_ms(model, batch, phase)
    return launches, times, peak, busy, deform_ms, plugin_ms


def zoo_train_check(name, device='cuda', cpu=None):
    """Phase 7's check on a zoo detector through phase_train_check: fp32
    on phase 7's 224x320 batch, the card against the CPU, same seeded
    weights, batch and sampler keys, proposals pinned; the backbone's
    gradients at RESNET_GRAD_LIMIT, the rest at phase 7's limits; the bf16
    control must exceed them; gn_ws's limits are ZOO_TRAIN_LIMITS'.
    ``cpu``: zoo_check's CPU model (same seed, options and drawn heads and
    plugins), else one is built."""
    backbone = {**ZOO_BACKBONE_GRADS, **BACKBONE_GRADS}[name]
    heads = {**ZOO_HEAD_GRADS, **BACKBONE_HEAD_GRADS}[name]
    if cpu is None:
        cpu = _zoo_check_model(name)
    phase_train_check(device=device, config=ZOO_ALL[name], cpu=cpu,
                      names=backbone + heads,
                      pin_proposals=True, opts=(('bf16', False),),
                      **ZOO_TRAIN_LIMITS.get(name, dict(limits=({}, dict(
                          TOL_TRAIN_GRAD, **{n: RESNET_GRAD_LIMIT
                                             for n in backbone})))))


def zoo_files(name='mdconv'):
    """From files: train_detector for one epoch on 2 of phase 10's PNGs
    with the config's own pipeline (one iteration), then tools.test on
    them with the trained checkpoint, --eval bbox (and segm for a mask
    config), score_thr 0: 100 detections an image."""
    phase = f'zoo-{name}-files'
    build_dir = os.path.join(REPO, 'build')
    os.makedirs(build_dir, exist_ok=True)
    config = ZOO_ALL[name]
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        ann_file, prefix = write_synthetic_coco(root, RESNET_LOOP_SIZES)
        work = os.path.join(root, 'work')
        cfg = loop_config(ann_file, prefix, work, config=config)
        cfg.model.pretrained = None
        if BACKBONE_TYPES.get(name) == 'HRNet':
            cfg.load_from = _unit_neck_checkpoint(cfg, root)
        model = build_detector(dict(cfg.model, dtype='bfloat16'))
        per = zoo_launches(model, training=True)
        reset_launch_counts()
        t0 = time.perf_counter()
        run = train_detector(model, build_dataset(cfg.data.train), cfg)
        torch.cuda.synchronize()
        launches = launch_counts()
        log(phase, f'train_detector: {len(run.log_vars)} iterations in '
                   f'{time.perf_counter() - t0:.1f} s, canvases '
                   f'{run.canvases}; loss ' + ', '.join(
                       f'{v["loss"]:.4g}' for v in run.log_vars))
        bad = [v for v in run.log_vars
               if not all(np.isfinite(x) for x in v.values())]
        if len(run.log_vars) != 1 or bad or launches != per:
            raise AssertionError(f'{name}: {len(run.log_vars)} iterations, '
                                 f'non-finite {bad}, launches '
                                 f'{_nonzero(launches)} (expected '
                                 f'{_nonzero(per)})')
        cfg_file = os.path.join(root, f'{name}_cfg.py')
        eval_config(ann_file, prefix, config=config).dump(cfg_file)
        metrics = ['bbox', 'segm'] if model.roi_head.with_mask else ['bbox']
        ran, launches, dets = _cli_run(phase, [
            cfg_file, os.path.join(work, 'epoch_1.pth'), '--samples-per-gpu',
            '2', '--eval', *metrics, '--cfg-options', 'bf16=True',
            'model.test_cfg.rcnn.score_thr=0.0'], 'test')
        want = zoo_launches(model, training=False)
        if dets != [100, 100] or launches != want or not all(
                np.isfinite(v) for v in ran['metrics'].values()
                if isinstance(v, float)):
            raise AssertionError(f'{name} test: detections {dets}, launches '
                                 f'{_nonzero(launches)} (expected '
                                 f'{_nonzero(want)}), metrics '
                                 f'{ran["metrics"]}')
        _check_tc(phase, launches, True, (conv3x3,))
        log(phase, f'test: metrics {dict(ran["metrics"])}')


def _zoo_configs(label, configs, trained, files):
    """Each config of ``configs`` serving and its fp32 serving check; those
    in ``trained`` training and their fp32 training checks (on the
    serving check's CPU model); train_detector and tools.test from files
    for ``files``; each lap's time logged. Returns each config's serving
    and training results and the phase's seconds."""
    start = last = time.perf_counter()
    laps = []

    def lap(what):
        nonlocal last
        now = time.perf_counter()
        laps.append(f'{what} {now - last:.1f} s')
        log('time', f'{label}: {laps[-1]}')
        last = now
    out = {}
    for name in configs:
        serve, lat = zoo_serve(name)
        lap(f'{name} serving')
        cpu = zoo_check(name)
        lap(f'{name} serving check')
        out[name] = dict(serve=serve, lat=lat)
        if name in trained:
            train, times, peak, busy, deform_ms, plugin_ms = zoo_train(name)
            lap(f'{name} training')
            zoo_train_check(name, cpu=cpu)
            lap(f'{name} training check')
            out[name].update(train=train, times=times, peak=peak, busy=busy,
                             deform_ms=deform_ms, plugin_ms=plugin_ms)
        del cpu
    zoo_files(files)
    lap(f'{files} files')
    seconds = time.perf_counter() - start
    log('time', f'{label}: ' + ', '.join(laps) + f'; {seconds:.1f} s')
    return out, seconds


def phase_zoo():
    """Phase 15: the seven zoo configs serving and their fp32 serving
    checks; four of them training and their fp32 training checks;
    train_detector and tools.test from files for mdconv. Returns each
    config's serving and training results."""
    return _zoo_configs('zoo (phase 15)', ZOO_CONFIGS, ZOO_TRAINED,
                        'mdconv')[0]


# ------------------------------------------------------------ phase 16
# the ResNet plugins and the ResNet-family backbones: ContextBlock and
# GeneralizedAttention in a ResNet-50, RegNetX-3.2GF, Res2Net-101,
# ResNeSt-50 and HRNetV2p-W32 with HRFPN
BACKBONE_CONFIGS = {
    'gcb': 'configs/gcnet/mask_rcnn_r50_fpn_r4_gcb_c3-c5_1x_coco.py',
    'attn': 'configs/empirical_attention/'
            'faster_rcnn_r50_fpn_attention_1111_1x_coco.py',
    'regnet': 'configs/regnet/faster_rcnn_regnetx-3.2GF_fpn_1x_coco.py',
    'res2net': 'configs/res2net/faster_rcnn_r2_101_fpn_2x_coco.py',
    'resnest': 'configs/resnest/faster_rcnn_s50_fpn_syncbn-backbone+head_'
               'mstrain-range_1x_coco.py',
    'hrnet': 'configs/hrnet/mask_rcnn_hrnetv2p_w32_1x_coco.py',
}
BACKBONE_CONFIGS = {k: os.path.join(REPO, v)
                    for k, v in BACKBONE_CONFIGS.items()}
BACKBONE_TYPES = {'gcb': 'ResNet', 'attn': 'ResNet', 'regnet': 'RegNet',
                  'res2net': 'Res2Net', 'resnest': 'ResNeSt',
                  'hrnet': 'HRNet'}
# the four with new autograd paths: the plugins' pooling and energy
# terms, the radix softmax, HRNet's fuse (regnet and res2net train on the
# CPU against the JAX package, tests/test_torch_backbone*.py)
BACKBONE_TRAINED = ('gcb', 'attn', 'resnest', 'hrnet')
# the gradients the fp32 training checks hold: the backbone's (a plugin
# parameter among them: ContextBlock's transform and mask convs,
# GeneralizedAttention's gamma and query and key convs; the split
# attention's convs; HRNet's fuse and transition convs) behind the ReLU
# path at RESNET_GRAD_LIMIT, the neck's and heads' at phase 7's limits
BACKBONE_GRADS = {
    'gcb': ('backbone.layer2.0.conv1.weight',
            'backbone.layer3.5.conv2.weight',
            'backbone.layer3.5.context_block.conv_mask.weight',
            'backbone.layer3.5.context_block.channel_add_conv.0.weight',
            'backbone.layer4.2.context_block.channel_add_conv.3.weight',
            'backbone.layer4.2.bn3.weight'),
    'attn': ('backbone.layer2.0.conv1.weight',
             'backbone.layer3.5.conv2.weight',
             'backbone.layer3.5.gen_attention_block.gamma',
             'backbone.layer3.5.gen_attention_block.query_conv.weight',
             'backbone.layer4.2.gen_attention_block.key_conv.weight',
             'backbone.layer4.2.gen_attention_block.appr_geom_fc_x.weight',
             'backbone.layer4.2.bn3.weight'),
    'resnest': ('backbone.layer2.0.conv1.weight',
                'backbone.layer3.5.conv2.conv.weight',
                'backbone.layer3.5.conv2.fc2.weight',
                'backbone.layer4.2.conv3.weight',
                'backbone.layer4.2.bn3.weight'),
    'hrnet': ('backbone.conv1.weight', 'backbone.layer1.0.conv1.weight',
              'backbone.transition3.3.0.0.weight',
              'backbone.stage3.3.fuse_layers.0.1.0.weight',
              'backbone.stage4.2.fuse_layers.3.0.2.0.weight',
              'backbone.stage4.2.branches.0.3.conv2.weight'),
}
FASTER_HEAD_GRADS = ('neck.fpn_convs.0.conv.weight',
                     'rpn_head.rpn_conv.weight',
                     'roi_head.bbox_head.shared_fcs.0.weight',
                     'roi_head.bbox_head.fc_cls.weight')
BACKBONE_HEAD_GRADS = {
    'gcb': ZOO_HEAD_GRADS['mdconv'], 'attn': FASTER_HEAD_GRADS,
    'resnest': FASTER_HEAD_GRADS,
    'hrnet': ('neck.reduction_conv.conv.weight',
              'neck.fpn_convs.0.conv.weight', 'rpn_head.rpn_conv.weight',
              'roi_head.bbox_head.shared_fcs.0.weight',
              'roi_head.bbox_head.fc_cls.weight',
              'roi_head.mask_head.convs.0.conv.weight'),
}
ZOO_ALL = {**ZOO_CONFIGS, **BACKBONE_CONFIGS}


def phase_backbones():
    """Phase 16: the six configs serving and their fp32 serving checks;
    gcb, attn, resnest and hrnet training and their fp32 training checks;
    train_detector and tools.test from files for hrnet (HRFPN). Returns
    each config's serving and training results and the phase's
    seconds."""
    return _zoo_configs('backbones (phase 16)', BACKBONE_CONFIGS,
                        BACKBONE_TRAINED, 'hrnet')


# ------------------------------------------------------------ phase 17
# RPN-only and Fast R-CNN, FCOS and NAS-FCOS
DENSE_CONFIGS = {
    'rpn': 'configs/rpn/rpn_r50_fpn_1x_coco.py',
    'rpn_c4': 'configs/rpn/rpn_r50_caffe_c4_1x_coco.py',
    'fast_rcnn': 'configs/fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py',
    'fcos': 'configs/fcos/fcos_r50_fpn_1x_coco.py',
    'fcos_gn': 'configs/fcos/fcos_center-normbbox-centeronreg-giou_r50_'
               'caffe_fpn_gn-head_1x_coco.py',
    'nasfcos': 'configs/nas_fcos/nas_fcos_nashead_r50_caffe_fpn_gn-head_'
               '4x4_1x_coco.py',
}
DENSE_CONFIGS = {k: os.path.join(REPO, v) for k, v in DENSE_CONFIGS.items()}
# the C4 RPN serves only: its training is the FPN RPN's loss on one map
DENSE_TRAINED = ('rpn', 'fast_rcnn', 'fcos', 'fcos_gn', 'nasfcos')
DENSE_REQUESTS = 2
DENSE_STEPS = 3
# Fast R-CNN's static proposal slots in training (the config's
# LoadProposals num_max_proposals); at test time the RPN's max_per_img
FAST_RCNN_SLOTS = 2000
# the gradients the fp32 training checks hold; the ResNet's, the FPN's
# first output conv's and FCOS's first tower conv's behind ReLU units at
# RESNET_GRAD_LIMIT (as RetinaNet's, phase 14), the rest at phase 7's
# RPN-group limit
DENSE_TRAIN_GRADS = {
    'rpn': RESNET_BACKBONE_GRADS + (
        'neck.lateral_convs.0.conv.weight', 'neck.fpn_convs.0.conv.weight',
        'rpn_head.rpn_conv.weight', 'rpn_head.rpn_cls.weight',
        'rpn_head.rpn_reg.weight'),
    'fcos': RESNET_BACKBONE_GRADS + (
        'neck.fpn_convs.0.conv.weight', 'neck.fpn_convs.2.conv.weight',
        'bbox_head.cls_convs.0.conv.weight',
        'bbox_head.reg_convs.3.conv.weight', 'bbox_head.conv_cls.weight',
        'bbox_head.conv_reg.weight', 'bbox_head.conv_centerness.weight',
        'bbox_head.scales.0.scale'),
}
DENSE_DEEP_GRADS = RESNET_BACKBONE_GRADS + (
    'neck.fpn_convs.0.conv.weight', 'bbox_head.cls_convs.0.conv.weight')


def dense_launches(model, training):
    """Each kernel's launches that one request (serving) or one step
    (training) of a phase-17 detector makes, derived from the built
    model: a conv3x3 launch per kernel FPN output conv, per level of a
    kernel RPN conv (the C4 RPN's one map) and per level of each kernel
    tower conv of an FCOS head (in training one more each for dx and a
    filter-gradient launch each; NAS-FCOS's neck and GN towers, FCOS's
    GN towers and its 3x3 outputs run F.conv2d); Fast R-CNN's bbox
    RoIAlign once a request and once a step with its backward; the NMS
    once a request (the RPN's proposals, the dense heads' and Fast
    R-CNN's multiclass) and never in training (no proposal step). A
    distilling detector's teacher (LD) runs its kernel convs forward in
    every training step, and not at all in serving."""
    convs = sum(c.use_kernel for c in getattr(model.neck, 'fpn_convs', ()))
    aligns = 0
    if hasattr(model, 'bbox_head'):
        head = model.bbox_head
        convs += len(_head_strides(head)) * sum(
            c.use_kernel for c in (*head.cls_convs, *head.reg_convs))
    elif model.rpn_head is not None:
        head = model.rpn_head
        convs += head.conv_uses_kernel * len(head.prior_generator.strides)
    else:
        aligns = 1
    want = {fn.__name__: 0 for fn in KERNEL_WRAPPERS}
    if training:
        teacher = getattr(model, 'teacher_model', None)
        forward_only = 0 if teacher is None else dense_launches(
            teacher, training=False)['conv3x3']
        want.update(conv3x3=2 * convs + forward_only, conv3x3_dw=convs,
                    roi_align=aligns, roi_align_bwd=aligns)
    else:
        want.update(conv3x3=convs, roi_align=aligns, nms_sorted=1)
    return want


def _head_strides(head):
    """A dense head's level strides: an FCOS-style head's own, an anchor
    head's its anchor generator's."""
    return getattr(head, 'strides', None) or head.prior_generator.strides


def _dense_phase(name):
    """The log prefix of a phase-17 ('dense'), phase-18 ('atss') or
    phase-19 ('paa-ld') config."""
    if name in PAA_LD_CONFIGS:
        return 'paa-ld'
    return 'atss' if name in ATSS_CONFIGS else 'dense'


def _launched(per, kernels):
    """The wrappers of ``kernels`` that the derived launches ``per``
    expect to run."""
    return tuple(fn for fn in kernels if per[fn.__name__])


def _dense_model(name, device='cuda', seed=0, opts=RESNET_BF16):
    return init_detector(_dense_config(name),
                         device=device, seed=seed,
                         cfg_options=dict(opts))


def _dense_config(name):
    """The config file of a phase-17, 18 or 19 config."""
    return {**DENSE_CONFIGS, **ATSS_CONFIGS, **PAA_LD_CONFIGS}[name]


def _check_proposals(res, h, w, max_n):
    """An RPN's result: 80 classes, every proposal in class 0, finite,
    within the (h, w) canvas, at most ``max_n``; returns their number."""
    if len(res) != 80 or any(len(r) for r in res[1:]):
        raise AssertionError('proposals outside class 0')
    dets = res[0]
    if dets.ndim != 2 or dets.shape[1] != 5 or not np.isfinite(dets).all() \
            or (dets[:, [0, 2]] > w + 1e-3).any() \
            or (dets[:, [1, 3]] > h + 1e-3).any() or (dets < 0).any() \
            or not 0 < len(dets) <= max_n:
        raise AssertionError(f'bad proposals {dets.shape}')
    return len(dets)


def _cls_conv(head):
    """A dense head's class output conv (FCOS', ATSS', GFL's, VFNet's)."""
    for name in ('conv_cls', 'atss_cls', 'gfl_cls', 'vfnet_cls'):
        if hasattr(head, name):
            return getattr(head, name)
    raise AttributeError(f'{type(head).__name__}: no class output')


def _cness_conv(head):
    """A dense head's centerness output conv (FCOS', ATSS'), or None."""
    return getattr(head, 'conv_centerness',
                   getattr(head, 'atss_centerness', None))


def _shift_cls_bias(model, img, phase):
    """Shift a dense head's class bias so that REPPOINTS_PAIRS (point,
    class) pairs of ``img``'s candidates clear score_thr by their score
    (times centerness, where the head has one: FCOS, ATSS), the multiclass
    NMS's cap full: seeded weights score every pair at the 0.01 prior
    (times ~0.5), under score_thr."""
    conv = _cls_conv(model.bbox_head)
    thr = dict(model.test_cfg)['score_thr']

    def candidates():
        from swindet_tpu_torch.apis.inference import preprocess_images
        batch = preprocess_images([img], model.cfg)
        dev = next(model.parameters()).device
        with torch.inference_mode():
            _, scores, cness = model.aug_bbox_test(
                torch.from_numpy(batch['img']).to(dev),
                torch.from_numpy(batch['img_shapes']).to(dev))
        z = torch.logit(scores[0, :, :-1].double())
        # the logit each pair must pass: thr's, or thr over its centerness
        if cness is None:
            return z, torch.full_like(z[:, :1], float(np.log(thr / (1 - thr))))
        need = torch.logit((thr / cness[0].double()).clamp(max=1 - 1e-9))
        return z, need[:, None]
    z, need = candidates()
    shift = torch.kthvalue((need - z).flatten(),
                           REPPOINTS_PAIRS).values.item() + 1e-3
    with torch.no_grad():
        conv.bias.add_(shift)
    z, need = candidates()
    pairs = int((z > need).sum())
    log(phase, f'class bias shifted by {shift:.4f}: {pairs} of '
               f'{z.numel()} candidate pairs of the warm-up request clear '
               f'score_thr {thr} by score (times centerness)')
    if pairs < REPPOINTS_PAIRS // 2:
        raise AssertionError(f'{pairs} pairs clear score_thr: the NMS cap '
                             f'of {REPPOINTS_PAIRS // 2} is not full')


def _timed_requests(phase, model, imgs, per, run, check):
    """A warm-up request, then one per image after it with every launch
    count checked: latencies, detection counts, launches and the peak
    memory of the timed requests."""
    t0 = time.perf_counter()
    check(run(imgs[0]))
    torch.cuda.synchronize()
    log(phase, f'warm-up request {time.perf_counter() - t0:.3f} s')
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lat, counts = [], []
    for img in imgs[1:]:
        t0 = time.perf_counter()
        res = run(img)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        counts.append(check(res))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_launches(phase, launches, per, len(imgs) - 1)
    # NAS-FCOS runs no conv on the kernel: none may launch
    tc = _check_tc(phase, launches, True, _launched(per, (conv3x3,)))
    log(phase, 'per-request ms: '
               + ', '.join(f'{t * 1e3:.1f}' for t in lat)
               + f'; detections per image {counts}; peak memory '
                 f'{peak / 2 ** 30:.2f} GiB; launches {_nonzero(launches)}'
                 f', as derived; tensor-core {_nonzero(tc)}; {CARD}')
    return launches, lat, peak, counts


def _rpn_proposals(rpn, img, shapes, sf, slots=None):
    """The RPN's proposals in the canvas frame (rescale off) and their
    validity, padded to ``slots`` with invalid zero boxes."""
    with torch.inference_mode():
        out = rpn.simple_test(img, shapes, sf, rescale=False)
    props, valid = out['dets'][..., :4].clone(), out['det_valid'].clone()
    if slots is not None:
        b, n = valid.shape
        props = torch.cat([props, props.new_zeros(b, slots - n, 4)], 1)
        valid = torch.cat([valid, valid.new_zeros(b, slots - n)], 1)
    return props, valid


def dense_serve(name):
    """One phase-17 config in bf16 through init_detector and
    inference_detector (Fast R-CNN through preprocess_images, with the
    RPN config's test pipeline, and its simple_test on the FPN RPN's
    proposals of the same image, in bf16, made before the timed
    requests): a warm-up, then DENSE_REQUESTS
    requests at 800x1333 with every launch count checked; an FCOS head's
    class bias shifted first so that its NMS cap is full."""
    phase = f'{_dense_phase(name)}-{name}'
    t0 = time.perf_counter()
    model = _dense_model(name)
    per = dense_launches(model, training=False)
    log(phase, f'init_detector: {type(model).__name__} '
               f'{sum(p.numel() for p in model.parameters())} params, '
               f'compute {model.dtype}, {time.perf_counter() - t0:.1f} s; '
               f'launches per request {_nonzero(per)}')
    imgs = synthetic_images(DENSE_REQUESTS + 1, seed=9)
    if name.startswith('rpn'):
        max_n = dict(model.test_cfg)['rpn']['max_per_img']
        return _timed_requests(
            phase, model, imgs, per, lambda img: inference_detector(model,
                                                                    img),
            lambda res: _check_proposals(res, 800, 1344, max_n))
    if name != 'fast_rcnn':
        _shift_cls_bias(model, imgs[0], phase)

        def check(res):
            n = _check_bbox_result(res, 800, 1344)
            if n != 100:
                raise AssertionError(f'{n} detections with the cap full')
            return n
        return _timed_requests(phase, model, imgs, per,
                               lambda img: inference_detector(model, img),
                               check)
    from swindet_tpu_torch.apis.inference import preprocess_images
    rpn = _dense_model('rpn')
    batches = []
    for img in imgs:
        # the RPN config's test pipeline: the Fast R-CNN config's reads a
        # proposal file first (LoadProposals), and normalises and resizes
        # alike
        batch = preprocess_images([img], rpn.cfg)
        args = [torch.from_numpy(batch[k]).cuda()
                for k in ('img', 'img_shapes', 'scale_factors')]
        batches.append((batch['metas'], args, _rpn_proposals(rpn, *args)))
    del rpn
    log(phase, f'the FPN RPN\'s proposals a request: '
               f'{[int(b[2][1].sum()) for b in batches]}')

    def run(i):
        metas, args, (props, valid) = batches[i]
        with torch.inference_mode():
            out = model.simple_test(*args, props, valid)
        return format_results({k: v.cpu().numpy() for k, v in out.items()},
                              metas, 80)[0]
    return _timed_requests(phase, model, list(range(len(batches))), per,
                           run, lambda res: _check_bbox_result(res, 800,
                                                               1344))


def _fcos_check_heads(model, img, phase):
    """A dense head's centerness output (FCOS', ATSS', PAA's IoU) set to 0
    (a factor of 0.5 on every score, a constant, so that the top-k and the
    NMS rank the class logits alone) and its class logits to N(-14, 4^2)
    with every decision of get_bboxes at least 2e-4 in logits from its
    boundary (_set_class_logits, at score_thr's double where the score is
    the class score times 0.5, at 2 score_thr^2 where it is PAA's
    sqrt(class score x 0.5))."""
    head = model.bbox_head
    cness = _cness_conv(head)
    cfg = model.test_cfg
    if cness is not None:
        with torch.no_grad():
            cness.weight.zero_()
            cness.bias.zero_()
        thr = cfg['score_thr']
        paa = type(head).__name__ == 'PAAHead'
        model.test_cfg = dict(cfg, score_thr=2 * thr ** 2 if paa
                              else 2 * thr)
    try:
        scale, bias, margins = _set_class_logits(
            model, torch.from_numpy(img), conv=_cls_conv(head),
            candidates=False)
    finally:
        model.test_cfg = cfg
    log(phase, f'class output weight x{scale:.4g}, bias {bias:.4g}: '
               f'{margins[3]} candidate pairs clear score_thr; in logits, '
               f'the nearest to its {margins[0]:.3g} away, the smallest gap '
               f'at a level\'s top-k cut {margins[1]}, at the 2048-pair cap '
               f'{margins[2]}')


def _proposal_tuple(out):
    return out['dets'][..., :4], out['dets'][..., 4], out['det_valid']


def dense_check(name, device='cuda', control=True):
    """Phase 14's serving check on a phase-17 config: fp32 on a 224x320
    canvas, the card (kernels, no tensor-core launch) against the CPU
    (plain versions), same seeded weights; a bf16 control on the card
    that must exceed the limits. An RPN's proposals (rpn_cls spread) must
    match the CPU run's within TOL_PROPOSAL_PX, MIN_PROPOSAL_SHARE of
    them both ways (noise may trade a near-tied pair at an NMS boundary);
    the other configs' detections as sets
    (_matched_errors), boxes within 1e-2 px, scores within 1e-2 (Fast
    R-CNN, fc_cls spread, on the CPU's fp32 FPN RPN's proposals on both
    sides) or 1e-4 (FCOS and NAS-FCOS, _fcos_check_heads); features
    within 1e-3 of their largest entry."""
    phase = f'{_dense_phase(name)}-{name}-check'
    cpu = _dense_model(name, device='cpu', seed=1, opts={'bf16': False})
    img, shapes, sf = _zoo_check_inputs()
    extra = ()
    if name.startswith('rpn'):
        with torch.no_grad():
            cpu.rpn_head.rpn_cls.weight.mul_(100.0)
    elif name == 'fast_rcnn':
        with torch.no_grad():
            cpu.roi_head.bbox_head.fc_cls.weight.mul_(100.0)
        rpn = _dense_model('rpn', device='cpu', seed=1,
                           opts={'bf16': False})
        with torch.no_grad():
            rpn.rpn_head.rpn_cls.weight.mul_(100.0)
        extra = _rpn_proposals(rpn, *[torch.from_numpy(a)
                                      for a in (img, shapes, sf)])
        log(phase, f'the CPU FPN RPN\'s proposals: {int(extra[1].sum())}')
    else:
        _fcos_check_heads(cpu, img, phase)

    def outputs(model, dev):
        args = [torch.from_numpy(a).to(dev) for a in (img, shapes, sf)]
        with torch.inference_mode():
            feats = model.extract_feat(args[0])
            out = model.simple_test(*args, *[t.to(dev) for t in extra])
        return ([f.cpu().float() for f in feats],
                {k: v.cpu() for k, v in out.items()}, None)

    def errors(got):
        feat_err = max((a - b).abs().max().item()
                       / max(a.abs().max().item(), 1)
                       for a, b in zip(want[0], got[0]))
        if not name.startswith('rpn'):
            return feat_err, _matched_errors(want, got)[1]
        w, g = _proposal_tuple(want[1]), _proposal_tuple(got[1])
        return feat_err, (min(_matched_share(w, g), _matched_share(g, w)),
                          int(w[2].sum()), int(g[2].sum()))

    def over(errs, score_limit):
        feat_err, e = errs
        if name.startswith('rpn'):
            return feat_err > 1e-3 or e[0] < MIN_PROPOSAL_SHARE
        return e is None or feat_err > 1e-3 or e[0] > 1e-2 \
            or e[1] > score_limit or e[2] == 0
    score_limit = 1e-2 if name == 'fast_rcnn' else 1e-4
    gpu = _copy_model(cpu, 'float32', device)
    gpu = gpu.to(device).eval()
    want = outputs(cpu, 'cpu')
    reset_launch_counts()
    sound = errors(outputs(gpu, device))
    if device == 'cuda':
        _check_tc(phase, launch_counts(), False, _launched(
            dense_launches(gpu, training=False), (conv3x3,)))
    what = ('share of proposals matched both ways, valid on the CPU and '
            'the card' if name.startswith('rpn')
            else 'box max|d| px, score max|d|, dets')
    log(phase, f'224x320 fp32 card vs CPU: features rel max|d| '
               f'{sound[0]:.3g}; {what}: {sound[1]}')
    if over(sound, score_limit):
        raise AssertionError(f'{name}: card vs CPU over the limits')
    if not control:
        return
    ctl = _copy_model(cpu, 'bfloat16', device)
    control = errors(outputs(ctl.to(device).eval(), device))
    log(phase, f'bf16 control vs the fp32 CPU run: features rel max|d| '
               f'{control[0]:.3g}; {what}: {control[1]}')
    if not over(control, score_limit):
        raise AssertionError(f'{name}: the bf16 control passes the fp32 '
                             f'limits')


def _fast_rcnn_step(model, opt, schedule):
    """Fast R-CNN's training step (make_train_step passes no proposals,
    as the JAX package's): set the schedule's rate, forward_train on the
    batch's 'proposals' and 'prop_valid', parse_losses, backward, a zero
    gradient for every parameter the loss does not reach, the config's
    SGD step. Returns the log values with 'grad_norm'."""
    from swindet_tpu_torch.engine import parse_losses
    from swindet_tpu_torch.engine.optimizer import set_lr
    model.train()
    params = [p for p in model.parameters() if p.requires_grad]
    iteration = [0]

    def step(batch, gen):
        set_lr(opt, schedule(iteration[0]))
        opt.zero_grad(set_to_none=True)
        losses = model.forward_train(
            batch['img'], batch['img_shapes'], batch['pad_shapes'],
            batch['gt_bboxes'], batch['gt_valid'], batch['gt_labels'],
            batch['proposals'], batch['prop_valid'], gen=gen)
        total, log_vars = parse_losses(losses)
        total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        log_vars['grad_norm'] = torch.nn.utils.get_total_norm(
            [p.grad for p in params])
        opt.step()
        iteration[0] += 1
        names = list(log_vars)
        return dict(zip(names, torch.stack(
            [log_vars[k].detach().float() for k in names]).tolist()))
    return step


def dense_train(name):
    """1 + DENSE_STEPS training steps of a phase-17 config (its config in
    bf16, SGD) at batch 2 on the 800x1344 canvas with 16 painted
    rectangles an image: make_train_step for the RPN, FCOS and NAS-FCOS;
    for Fast R-CNN _fast_rcnn_step on the FPN RPN's proposals of the
    batch (bf16, seeded), padded to FAST_RCNN_SLOTS with invalid slots.
    Each step's launches checked, the frozen BN buffers unmoved, a
    profiled step (busy share), and for NAS-FCOS the plain deformable
    convs' ms."""
    phase = f'{_dense_phase(name)}-{name}-train'
    cfg = Config.fromfile(_dense_config(name))
    cfg.merge_from_dict(RESNET_BF16)
    model = _dense_model(name)
    opt = build_optimizer(model, dict(cfg.optimizer))
    if not isinstance(opt, torch.optim.SGD):
        raise AssertionError(f'{name}: optimizer {type(opt).__name__}')
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH)
    batch = synthetic_train_batch()
    del batch['gt_masks']
    if name == 'fast_rcnn':
        rpn = _dense_model('rpn')
        sf = torch.ones(2, 4, device=batch['img'].device)
        batch['proposals'], batch['prop_valid'] = _rpn_proposals(
            rpn, batch['img'], batch['img_shapes'], sf, FAST_RCNN_SLOTS)
        del rpn
        log(phase, f'the FPN RPN\'s proposals of the batch: '
                   f'{batch["prop_valid"].sum(1).tolist()} valid of '
                   f'{FAST_RCNN_SLOTS} slots an image')
        step = _fast_rcnn_step(model, opt, schedule)
    else:
        step = make_train_step(model, opt, schedule,
                               dict(cfg.optimizer_config).get('grad_clip'))
    per = dense_launches(model, training=True)
    gen = torch.Generator(device='cuda').manual_seed(0)
    stats = {k: v.clone() for k, v in model.named_buffers()}
    teacher = getattr(model, 'teacher_model', None)
    if teacher is not None:
        frozen = {k: v.clone() for k, v in teacher.state_dict().items()}
        if any(p.requires_grad for p in teacher.parameters()) or any(
                n.startswith('teacher_model.') for g in opt.param_groups
                for n in g['names']):
            raise AssertionError(f'{name}: the teacher takes gradients or '
                                 f'sits in the optimizer')
    t0 = time.perf_counter()
    _check_log(step(batch, gen), 'warm-up step')
    torch.cuda.synchronize()
    log(phase, f'warm-up step {time.perf_counter() - t0:.3f} s; launches '
               f'per step {_nonzero(per)}')
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(DENSE_STEPS):
        t0 = time.perf_counter()
        out = step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_log(out, 'timed step')
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_launches(phase, launches, per, DENSE_STEPS)
    tc = _check_tc(phase, launches, True,
                   _launched(per, (conv3x3, conv3x3_dw)))
    moved = [k for k, v in model.named_buffers()
             if not torch.equal(v, stats[k])]
    if moved:
        raise AssertionError(f'{name}: frozen BN buffers moved: {moved[:4]}')
    log(phase, 'per-step ms: ' + ', '.join(f'{t:.1f}' for t in times)
               + f'; peak memory {peak / 2 ** 30:.2f} GiB; last step: '
               + ', '.join(f'{k} {v:.4f}' for k, v in out.items())
               + f'; launches {_nonzero(launches)}, as derived; '
                 f'tensor-core {_nonzero(tc)}; {CARD}')
    busy = _profile_steps(step, batch, gen, float(np.median(times)), phase,
                          n=1)
    deform_ms, em = 0.0, None
    if name == 'nasfcos':
        deform_ms = _deform_ops_ms(model, batch, phase)[0]
    elif name == 'vfnet':
        from swindet_tpu_torch.ops.deform_conv import DeformConv2d
        deform_ms = _module_ms(model, batch, phase, 'deformable convs',
                               (DeformConv2d,))[0]
    elif name == 'paa':
        em = _em_ms(model, batch, phase)
    if teacher is not None:
        moved = [k for k, v in teacher.state_dict().items()
                 if not torch.equal(v, frozen[k])]
        if moved or teacher.training:
            raise AssertionError(f'{name}: the teacher moved ({moved[:4]}) '
                                 f'or left eval mode')
        log(phase, f'the teacher\'s {len(frozen)} parameters and buffers '
                   f'bit-equal after {DENSE_STEPS + 2} steps, eval mode')
    return dict(train=launches, times=times, train_peak=peak, busy=busy,
                deform_ms=deform_ms, em=em)


def _dense_train_grads(model, batch, dev, names, keys=None):
    """forward_train on ``dev`` (the RPN's sampler drawing ``keys``): its
    losses and the gradients of ``names`` from their sum."""
    model.train()
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
          if k != 'gt_masks'}
    losses = model.forward_train(
        tb['img'], tb['img_shapes'], tb['pad_shapes'], tb['gt_bboxes'],
        tb['gt_valid'], tb['gt_labels'],
        sampler_keys=None if keys is None else dict(rpn=_to(keys, dev)))
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(sum(losses.values()),
                                [params[n] for n in names])
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: g.detach().cpu() for n, g in zip(names, grads)})


def dense_train_check(name, device='cuda'):
    """Phase 7's check on the RPN and FCOS (and phase 18's GFL and VFNet):
    forward_train in fp32 on phase 7's 224x320 batch, the card (kernels,
    no tensor-core launch) against the CPU (plain versions), same seeded
    weights, batch and (the RPN's) sampler keys: the losses at
    TOL_TRAIN_LOSS, the gradients of DENSE_TRAIN_GRADS (ATSS_TRAIN_GRADS)
    at RESNET_GRAD_LIMIT (DENSE_DEEP_GRADS, ATSS_DEEP_GRADS) or phase 7's
    RPN-group limit; a bf16 control on the card must exceed a loss limit
    and a gradient limit."""
    phase = f'{_dense_phase(name)}-{name}-train-check'
    names = {**DENSE_TRAIN_GRADS, **ATSS_TRAIN_GRADS,
             **PAA_LD_TRAIN_GRADS}[name]
    cpu = _dense_model(name, device='cpu', seed=1, opts={'bf16': False})
    batch = train_check_batch()
    keys = None
    if name == 'rpn':
        cpu.eval()
        with torch.no_grad():
            feats = cpu.extract_feat(torch.from_numpy(batch['img'][:1]))
        n = sum(a * f.shape[1] * f.shape[2] for a, f in zip(
            cpu.rpn_head.prior_generator.num_base_anchors, feats))
        rs = np.random.RandomState(7)
        keys = [tuple(rs.rand(n).astype(np.float32) for _ in range(2))
                for _ in range(batch['img'].shape[0])]
    gpu = _copy_model(cpu, 'float32', device)
    ctl = _copy_model(cpu, 'bfloat16', device)
    t0 = time.perf_counter()
    ref = _dense_train_grads(cpu, batch, 'cpu', names, keys)
    log(phase, f'the CPU run {time.perf_counter() - t0:.1f} s; losses '
               + ', '.join(f'{k} {v:.5g}' for k, v in ref[0].items()))
    reset_launch_counts()
    sound = _rp_train_errors(ref, _dense_train_grads(gpu.to(device), batch,
                                                     device, names, keys))
    if device == 'cuda':
        _check_launches(phase, launch_counts(),
                        dense_launches(gpu, training=True), 1)
        _check_tc(phase, launch_counts(), False, (conv3x3, conv3x3_dw))
    control = _rp_train_errors(ref, _dense_train_grads(
        ctl.to(device), batch, device, names, keys))
    _check_dense_train_errors(name, phase, sound, control)


def _check_dense_train_errors(name, phase, sound, control):
    """Log a dense config's fp32 card-vs-CPU training errors and its bf16
    control's; fail where the first exceed TOL_TRAIN_LOSS and the gradient
    limits, or the control passes a loss limit or a gradient limit."""
    for what, (loss, grad) in (('fp32 card vs CPU', sound),
                               ('control, bf16 card vs fp32 CPU', control)):
        log(phase, f'224x320 {what}: relative loss |d| ' + ', '.join(
            f'{k} {v:.3g}' for k, v in loss.items()))
        log(phase, '  grad |d| / max: ' + ', '.join(
            f'{n} {v:.3g}' for n, v in grad.items()))

    deep = PAA_LD_DEEP_GRADS if name in PAA_LD_CONFIGS else \
        ATSS_DEEP_GRADS if name in ATSS_CONFIGS else DENSE_DEEP_GRADS

    def over(errs):
        return [k for k, v in errs[0].items() if not v <= TOL_TRAIN_LOSS] \
            + [n for n, v in errs[1].items() if not v <= (
                RESNET_GRAD_LIMIT if n in deep else TOL_TRAIN_GRAD['rpn'])]
    if over(sound):
        raise AssertionError(f'{name}: card vs CPU over the limits: '
                             f'{over(sound)}')
    if not any(k in over(control) for k in control[0]) \
            or not any(n in over(control) for n in control[1]):
        raise AssertionError(f'{name}: the bf16 control passes the loss or '
                             f'the gradient limits')


def dense_files():
    """From files: the FPN RPN through train_detector for one epoch on 2
    of phase 10's PNGs with the config's own pipeline (one iteration),
    then tools.test on them with the trained checkpoint, --eval proposal:
    AR@100, AR@300 and AR@1000 (useCats 0)."""
    phase = 'dense-rpn-files'
    build_dir = os.path.join(REPO, 'build')
    os.makedirs(build_dir, exist_ok=True)
    config = DENSE_CONFIGS['rpn']
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        ann_file, prefix = write_synthetic_coco(root, RESNET_LOOP_SIZES)
        work = os.path.join(root, 'work')
        cfg = loop_config(ann_file, prefix, work, config=config)
        model = build_detector(dict(cfg.model, dtype='bfloat16'))
        per = dense_launches(model, training=True)
        reset_launch_counts()
        t0 = time.perf_counter()
        run = train_detector(model, build_dataset(cfg.data.train), cfg)
        torch.cuda.synchronize()
        launches = launch_counts()
        log(phase, f'train_detector: {len(run.log_vars)} iterations in '
                   f'{time.perf_counter() - t0:.1f} s, canvases '
                   f'{run.canvases}; loss ' + ', '.join(
                       f'{v["loss"]:.4g}' for v in run.log_vars))
        bad = [v for v in run.log_vars
               if not all(np.isfinite(x) for x in v.values())]
        if len(run.log_vars) != 1 or bad or launches != per:
            raise AssertionError(f'rpn: {len(run.log_vars)} iterations, '
                                 f'non-finite {bad}, launches '
                                 f'{_nonzero(launches)} (expected '
                                 f'{_nonzero(per)})')
        cfg_file = os.path.join(root, 'rpn_cfg.py')
        eval_config(ann_file, prefix, config=config).dump(cfg_file)
        ran, launches, dets = _cli_run(phase, [
            cfg_file, os.path.join(work, 'epoch_1.pth'), '--samples-per-gpu',
            '2', '--eval', 'proposal', '--cfg-options', 'bf16=True'], 'test')
        want = dense_launches(model, training=False)
        metrics = dict(ran['metrics'])
        ar = {k: metrics.get(k) for k in ('AR@100', 'AR@300', 'AR@1000')}
        if launches != want or not all(0 < d <= 1000 for d in dets) \
                or not all(v is not None and np.isfinite(v)
                           for v in ar.values()):
            raise AssertionError(f'rpn test: proposals {dets}, launches '
                                 f'{_nonzero(launches)} (expected '
                                 f'{_nonzero(want)}), metrics {metrics}')
        _check_tc(phase, launches, True, (conv3x3,))
        log(phase, f'test --eval proposal: ' + ', '.join(
            f'{k} {v}' for k, v in ar.items()) + f'; all metrics {metrics}')


def phase_dense():
    """Phase 17: the six configs serving and their fp32 serving checks;
    all but the C4 RPN training, the RPN and FCOS with their fp32
    training checks; the FPN RPN from files. Returns each config's
    results and the phase's seconds."""
    start = last = time.perf_counter()
    laps = []

    def lap(what):
        nonlocal last
        now = time.perf_counter()
        laps.append(f'{what} {now - last:.1f} s')
        log('time', f'dense (phase 17): {laps[-1]}')
        last = now
    out = {}
    for name in DENSE_CONFIGS:
        serve, lat, peak, counts = dense_serve(name)
        lap(f'{name} serving')
        dense_check(name)
        lap(f'{name} serving check')
        out[name] = dict(serve=serve, lat=lat, peak=peak, counts=counts)
        if name in DENSE_TRAINED:
            out[name].update(dense_train(name))
            lap(f'{name} training')
        if name in DENSE_TRAIN_GRADS:
            dense_train_check(name)
            lap(f'{name} training check')
    dense_files()
    lap('rpn files')
    seconds = time.perf_counter() - start
    log('time', 'dense (phase 17): ' + ', '.join(laps) + f'; {seconds:.1f} s')
    return out, seconds


# ------------------------------------------------------------ phase 18
ATSS_CONFIGS = {
    'atss': 'configs/atss/atss_r50_fpn_1x_coco.py',
    'gfl': 'configs/gfl/gfl_r50_fpn_1x_coco.py',
    'vfnet': 'configs/vfnet/vfnet_r50_fpn_1x_coco.py',
}
ATSS_CONFIGS = {k: os.path.join(REPO, v) for k, v in ATSS_CONFIGS.items()}
# the gradients GFL's and VFNet's fp32 training checks hold, at phase 17's
# limits (ATSS_DEEP_GRADS at RESNET_GRAD_LIMIT)
ATSS_TRAIN_GRADS = {
    'gfl': RESNET_BACKBONE_GRADS + (
        'neck.fpn_convs.0.conv.weight', 'neck.fpn_convs.2.conv.weight',
        'bbox_head.cls_convs.0.conv.weight',
        'bbox_head.reg_convs.3.conv.weight', 'bbox_head.gfl_cls.weight',
        'bbox_head.gfl_reg.weight', 'bbox_head.scales.0.scale'),
    'vfnet': RESNET_BACKBONE_GRADS + (
        'neck.fpn_convs.0.conv.weight', 'neck.fpn_convs.2.conv.weight',
        'bbox_head.cls_convs.0.conv.weight',
        'bbox_head.reg_convs.2.conv.weight',
        'bbox_head.vfnet_reg_conv.conv.weight', 'bbox_head.vfnet_reg.weight',
        'bbox_head.vfnet_reg_refine_dconv.weight',
        'bbox_head.vfnet_reg_refine.weight',
        'bbox_head.vfnet_cls_dconv.weight', 'bbox_head.vfnet_cls.weight',
        'bbox_head.scales.0.scale', 'bbox_head.scales_refine.0.scale'),
}
# the convs whose gradients come through the heads' GN + ReLU towers
# (the FPN's last output conv, on which the extra levels build too, and
# VFNet's last regression tower conv) move by more than 1e-4 of their
# largest entry under 1e-7 input noise on the CPU alone, as the ResNet's
# and the first tower conv's do: they are held at RESNET_GRAD_LIMIT
ATSS_DEEP_GRADS = DENSE_DEEP_GRADS + ('neck.fpn_convs.2.conv.weight',
                                      'bbox_head.reg_convs.2.conv.weight')


def phase_atss():
    """Phase 18: the three configs serving with their fp32 serving checks
    and training, GFL's and VFNet's fp32 training checks. Returns each
    config's results and the phase's seconds."""
    start = last = time.perf_counter()
    laps = []

    def lap(what):
        nonlocal last
        now = time.perf_counter()
        laps.append(f'{what} {now - last:.1f} s')
        log('time', f'atss (phase 18): {laps[-1]}')
        last = now
    out = {}
    for name in ATSS_CONFIGS:
        serve, lat, peak, counts = dense_serve(name)
        lap(f'{name} serving')
        dense_check(name)
        lap(f'{name} serving check')
        out[name] = dict(serve=serve, lat=lat, peak=peak, counts=counts,
                         **dense_train(name))
        lap(f'{name} training')
        # the FPN's output convs and the NMS in serving, the convs and
        # their filter gradients in training
        for key, kernels in (('serve', (conv3x3, nms_sorted)),
                             ('train', (conv3x3, conv3x3_dw))):
            idle = [fn.__name__ for fn in kernels
                    if not out[name][key][fn.__name__]]
            if idle:
                raise AssertionError(f'{name}: no {key} launch of {idle}')
        if name in ATSS_TRAIN_GRADS:
            dense_train_check(name)
            lap(f'{name} training check')
    seconds = time.perf_counter() - start
    log('time', 'atss (phase 18): ' + ', '.join(laps) + f'; {seconds:.1f} s')
    return out, seconds


# ------------------------------------------------------------ phase 19
PAA_LD_CONFIGS = {
    'paa': 'configs/paa/paa_r50_fpn_1x_coco.py',
    # its teacher_config: configs/gfl/gfl_r50_fpn_1x_coco.py, read from the
    # working directory, the checkout's root
    'ld': 'configs/ld/ld_r18_gflv1_r101_fpn_coco_1x.py',
}
PAA_LD_CONFIGS = {k: os.path.join(REPO, v) for k, v in PAA_LD_CONFIGS.items()}
# the LD student's ResNet-18: a conv of each unfrozen stage's first and
# last block, a BN scale
LD_BACKBONE_GRADS = (
    'backbone.layer2.0.conv1.weight',
    'backbone.layer3.1.conv2.weight',
    'backbone.layer4.1.conv2.weight',
    'backbone.layer4.1.bn2.weight')
# the gradients the fp32 training checks hold (LD: the student's), at
# phase 17's limits (PAA_LD_DEEP_GRADS at RESNET_GRAD_LIMIT)
PAA_LD_TRAIN_GRADS = {
    'paa': RESNET_BACKBONE_GRADS + (
        'neck.fpn_convs.0.conv.weight', 'neck.fpn_convs.2.conv.weight',
        'bbox_head.cls_convs.0.conv.weight',
        'bbox_head.reg_convs.3.conv.weight', 'bbox_head.atss_cls.weight',
        'bbox_head.atss_reg.weight', 'bbox_head.atss_centerness.weight',
        'bbox_head.scales.0.scale'),
    'ld': LD_BACKBONE_GRADS + (
        'neck.fpn_convs.0.conv.weight', 'neck.fpn_convs.2.conv.weight',
        'bbox_head.cls_convs.0.conv.weight',
        'bbox_head.reg_convs.3.conv.weight', 'bbox_head.gfl_cls.weight',
        'bbox_head.gfl_reg.weight', 'bbox_head.scales.0.scale'),
}
# behind the ReLU path, as phase 18's (ATSS_DEEP_GRADS)
PAA_LD_DEEP_GRADS = ATSS_DEEP_GRADS + LD_BACKBONE_GRADS


@contextlib.contextmanager
def paa_hooks(record=None, keep=None, em=None):
    """Patch the port's PAA head module for a block: ``record``, a dict,
    receives the sorted candidate losses and validity that the EM fits
    ('cl', 'cv'), the selection ('sel') and the keep mask (B, N) ('keep');
    ``keep`` replaces the keep mask PAA computes (pinning the assignment
    to another run's); ``em`` replaces gmm_em_1d."""
    from swindet_tpu_torch.models.dense_heads import paa_head as mod
    select, keep_fn, gmm = mod.paa_select, mod.paa_keep, mod.gmm_em_1d

    def paa_select(cl, cv, em_fn=gmm):
        sel, reads = select(cl, cv, em_fn)
        if record is not None:
            record.update(cl=cl.clone(), cv=cv.clone(), sel=sel.clone())
        return sel, reads

    def paa_keep(ci, sel, n):
        out = keep_fn(ci, sel, n)
        if record is not None:
            record['keep'] = out.clone()
        return out if keep is None else keep.to(out.device)
    mod.paa_select, mod.paa_keep = paa_select, paa_keep
    if em is not None:
        mod.gmm_em_1d = em
    try:
        yield
    finally:
        mod.paa_select, mod.paa_keep, mod.gmm_em_1d = select, keep_fn, gmm


def _em_ms(model, batch, phase):
    """The PAA EM's host-clock ms in one training forward of ``batch``
    (synchronized before and after, under no_grad), its host reads and the
    shape of the candidate rows it fits."""
    from swindet_tpu_torch.models.dense_heads.paa_head import gmm_em_1d
    runs = []

    def timed(x, valid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gmm_em_1d(x, valid)
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t0) * 1e3, out[2],
                     tuple(x.shape)))
        return out
    model.train()
    with paa_hooks(em=timed), torch.no_grad():
        model.forward_train(batch['img'], batch['img_shapes'],
                            batch['pad_shapes'], batch['gt_bboxes'],
                            batch['gt_valid'], batch['gt_labels'])
    ms, reads, rows = (sum(r[0] for r in runs), sum(r[1] for r in runs),
                       [r[2] for r in runs])
    log(phase, f'the EM (float64, on the card): {ms:.2f} ms a step (host '
               f'clock, synchronized), {reads} host reads, candidate rows '
               f'{rows}')
    return dict(ms=ms, reads=reads, rows=rows)


def paa_train_check(device='cuda'):
    """PAA's fp32 training check, in two parts, on phase 7's 224x320 batch
    with the same seeded weights on the card (kernels) and the CPU (plain
    versions). 1: the EM alone: the CPU's float64 EM on the candidate
    losses the card's run fitted, copied from the card, selects the same
    candidates as the card's EM did. 2: the whole step with the
    assignment pinned to the card's keep mask on every side (fp32 rounding
    of near-tied candidate losses could otherwise flip a row, as the
    proposals of pin_proposals=True): the losses at TOL_TRAIN_LOSS and the
    gradients of PAA_LD_TRAIN_GRADS at their limits; a bf16 control on the
    card, pinned alike, must exceed a loss limit and a gradient limit."""
    from swindet_tpu_torch.models.dense_heads.paa_head import paa_select
    name, phase = 'paa', 'paa-ld-paa-train-check'
    names = PAA_LD_TRAIN_GRADS[name]
    cpu = _dense_model(name, device='cpu', seed=1, opts={'bf16': False})
    batch = train_check_batch()
    gpu = _copy_model(cpu, 'float32', device)
    ctl = _copy_model(cpu, 'bfloat16', device)
    seen = {}
    reset_launch_counts()
    with paa_hooks(record=seen):
        got = _dense_train_grads(gpu.to(device), batch, device, names)
    if device == 'cuda':
        _check_launches(phase, launch_counts(),
                        dense_launches(gpu, training=True), 1)
        _check_tc(phase, launch_counts(), False, (conv3x3, conv3x3_dw))
    cl, cv, sel = (seen[k].cpu() for k in ('cl', 'cv', 'sel'))
    t0 = time.perf_counter()
    cpu_sel = paa_select(cl, cv)[0]
    log(phase, f'the EM alone: the card\'s {tuple(cl.shape)} candidate '
               f'losses ({int(cv.sum())} valid), fitted on the CPU in '
               f'{time.perf_counter() - t0:.2f} s: {int(cpu_sel.sum())} '
               f'selected, the card {int(sel.sum())}; equal '
               f'{torch.equal(cpu_sel, sel)}')
    if not torch.equal(cpu_sel, sel) or not sel.any():
        raise AssertionError('paa: the CPU\'s EM selects other candidates '
                             'than the card\'s, or none')
    keep = seen['keep']
    t0 = time.perf_counter()
    with paa_hooks(keep=keep.cpu()):
        ref = _dense_train_grads(cpu, batch, 'cpu', names)
    log(phase, f'the CPU run, assignment pinned to the card\'s '
               f'({int(keep.sum())} positives), '
               f'{time.perf_counter() - t0:.1f} s; losses '
               + ', '.join(f'{k} {v:.5g}' for k, v in ref[0].items()))
    sound = _rp_train_errors(ref, got)
    with paa_hooks(keep=keep):
        control = _rp_train_errors(ref, _dense_train_grads(
            ctl.to(device), batch, device, names))
    _check_dense_train_errors(name, phase, sound, control)


def phase_paa_ld():
    """Phase 19: PAA and LD serving with their fp32 serving checks,
    training (PAA with its EM's ms, LD with its teacher held bit-equal)
    and their fp32 training checks. Returns each config's results and the
    phase's seconds."""
    start = last = time.perf_counter()
    laps = []

    def lap(what):
        nonlocal last
        now = time.perf_counter()
        laps.append(f'{what} {now - last:.1f} s')
        log('time', f'paa-ld (phase 19): {laps[-1]}')
        last = now
    out = {}
    for name in PAA_LD_CONFIGS:
        serve, lat, peak, counts = dense_serve(name)
        lap(f'{name} serving')
        dense_check(name)
        lap(f'{name} serving check')
        out[name] = dict(serve=serve, lat=lat, peak=peak, counts=counts,
                         **dense_train(name))
        lap(f'{name} training')
        # the FPN's output convs and the NMS in serving, the convs and
        # their filter gradients in training
        for key, kernels in (('serve', (conv3x3, nms_sorted)),
                             ('train', (conv3x3, conv3x3_dw))):
            idle = [fn.__name__ for fn in kernels
                    if not out[name][key][fn.__name__]]
            if idle:
                raise AssertionError(f'{name}: no {key} launch of {idle}')
        if name == 'paa':
            paa_train_check()
        else:
            dense_train_check(name)
        lap(f'{name} training check')
    seconds = time.perf_counter() - start
    log('time', 'paa-ld (phase 19): ' + ', '.join(laps)
                + f'; {seconds:.1f} s')
    return out, seconds


# ------------------------------------------------------------ phase 20
# Hybrid Task Cascade R-50, with the fused semantic branch and without
HTC_CONFIGS = {
    'htc': 'configs/htc/htc_r50_fpn_1x_coco.py',
    'htc_without_semantic':
        'configs/htc/htc_without_semantic_r50_fpn_1x_coco.py',
}
HTC_CONFIGS = {k: os.path.join(REPO, v) for k, v in HTC_CONFIGS.items()}
HTC_REQUESTS = 2
HTC_STEPS = 3
# the training check's cut (phase 12's): CHECK_ROIS rois a stage an image,
# its CPU side the plain RoIAlign backward of every sampled roi
HTC_CHECK_CUTS = {f'model.train_cfg.rcnn.{i}.sampler.num': CHECK_ROIS
                  for i in range(3)}
# the gradients its fp32 training check holds: the ResNet's behind the
# ReLU path (RESNET_GRAD_LIMIT), the neck, the RPN conv, the semantic
# branch (its laterals, tower and logits take the semantic loss, its
# embedding the bbox and mask losses through the fusion), a bbox head of
# the first and the last stage, the first mask head and the last one's
# conv_res (the information flow)
HTC_TRAIN_GRADS = RESNET_BACKBONE_GRADS + (
    'neck.fpn_convs.0.conv.weight', 'rpn_head.rpn_conv.weight',
    'roi_head.semantic_head.lateral_convs.0.conv.weight',
    'roi_head.semantic_head.convs.3.conv.weight',
    'roi_head.semantic_head.conv_logits.weight',
    'roi_head.semantic_head.conv_embedding.conv.weight',
    'roi_head.bbox_head.0.fc_cls.weight',
    'roi_head.bbox_head.2.shared_fcs.1.weight',
    'roi_head.mask_head.0.convs.0.conv.weight',
    'roi_head.mask_head.2.conv_res.conv.weight')
# the semantic RoIAlign's shapes: one stride-8 level, an 800x1344
# canvas's P3, 14x14 bins
HTC_SEM_LEVEL = (100, 168)
HTC_STUFF_CLASSES = 183


def htc_launches(model, training):
    """Each kernel's launches that one request (serving) or one step
    (training) of an HTC makes, derived from the built model: a conv3x3
    launch per kernel ConvModule of the FPN, per RPN level, per semantic
    tower conv and per mask-head conv pass -- serving runs each stage's
    mask head once (the chain hands each its predecessor's tower output);
    in training, stage i's mask branch runs heads 0..i with the
    information flow, head i alone without -- and in training one more
    each for dx and a filter-gradient launch each; a RoIAlign launch per
    stage's bbox extractor call and per mask extractor call (one when
    serving, shared by the stages; one a stage in training), each with a
    second one on the semantic embedding where that branch is fused, in
    training each with its backward; NMS twice a request, once a step."""
    roi = model.roi_head
    n = roi.num_stages
    head = [sum(c.use_kernel for c in h.convs) for h in roi.mask_head]
    passes = sum(sum(head[:i + 1]) if roi.mask_info_flow else head[i]
                 for i in range(n)) if training else sum(head)
    convs = model.rpn_head.conv_uses_kernel \
        * len(model.rpn_head.prior_generator.strides) \
        + sum(c.use_kernel for c in model.neck.fpn_convs) + passes
    fused = set(roi.semantic_fusion) if roi.with_semantic else set()
    if roi.with_semantic:
        convs += sum(c.use_kernel for c in roi.semantic_head.convs)
    mask_calls = n if training else 1
    aligns = n * (1 + ('bbox' in fused)) + mask_calls * (1 + ('mask' in fused))
    want = {fn.__name__: 0 for fn in KERNEL_WRAPPERS}
    if training:
        want.update(conv3x3=2 * convs, conv3x3_dw=convs, roi_align=aligns,
                    roi_align_bwd=aligns, nms_sorted=1)
    else:
        want.update(conv3x3=convs, roi_align=aligns, nms_sorted=2)
    return want


def _htc_model(name, device='cuda', seed=0, opts=RESNET_BF16):
    model = init_detector(HTC_CONFIGS[name], device=device, seed=seed,
                          cfg_options=dict(opts))
    if type(model).__name__ != 'HybridTaskCascade' \
            or model.roi_head.with_semantic != (name == 'htc'):
        raise AssertionError(f'{name}: not the configured HTC')
    return model


def stuff_maps(n, canvas, img_hw, seed=0, stride=8):
    """Synthetic stuff maps of ``n`` images at 1/``stride`` of ``canvas``,
    as the HTC pipeline's Pad and SegRescale leave them: a 4 x 6 grid of
    blocks of labels 0-182 over the image (``img_hw``), 255 (ignored) on
    the padding."""
    rs = np.random.RandomState(seed + 200)
    sh, sw = canvas[0] // stride, canvas[1] // stride
    h, w = (int(v / stride + 0.5) for v in img_hw)
    blocks = rs.randint(0, HTC_STUFF_CLASSES, (n, 4, 6))
    rows = np.minimum(np.arange(sh) * 4 // sh, 3)
    cols = np.minimum(np.arange(sw) * 6 // sw, 5)
    seg = blocks[:, rows][:, :, cols].astype(np.uint8)
    seg[:, h:], seg[:, :, w:] = 255, 255
    return seg


def htc_kernel_checks(gen, randn):
    """Rows 4 and 9 at the semantic branch's shape, each against its plain
    version with its bound, in bf16 and fp32: RoIAlign of the stride-8
    embedding of an 800x1344 canvas (one level of 100x168x256) at 14x14,
    the pattern of a training step -- each of the 3 stages pools its 512
    rois an image of a batch of 2; one stage's rois, as the three share
    the shape -- forward and backward, and serving's
    1,000 proposals (the bbox fusion) and 100 detections (the mask
    fusion) of one image; each case's rois and the work they need, drawn
    and counted once, serve both dtypes. The backward must repeat bit for
    bit. Returns per dtype the forward's and the backward's rows."""
    c, size, strides = 256, 14, (8,)
    cases = []
    for n, b, what in ((1000, 1, 'serving, bbox fusion'),
                       (100, 1, 'serving, mask fusion'),
                       (1024, 2, 'training, a stage')):
        rois = _rois(gen, n, batch=b)
        cases.append((n, b, rois, _roi_work([HTC_SEM_LEVEL], rois, strides,
                                            size),
                      f'{n} rois {size}x{size}x{c}, one level at stride 8, '
                      f'{HTC_SEM_LEVEL[0]}x{HTC_SEM_LEVEL[1]}, batch {b} '
                      f'({what})'))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        el = torch.finfo(dtype).bits // 8
        fwd, bwd = [], []
        for n, b, rois, (touched, samples), note in cases:
            feats = [randn(b, *HTC_SEM_LEVEL, c).to(dtype)]
            fwd.append(_compare(
                'roi_align', dtype,
                lambda: roi_align(feats, rois, strides, size),
                lambda: multilevel_roi_align(feats, rois, strides, size),
                note, work=(touched * c * el + _nbytes(rois)
                            + n * size * size * c * el,
                            samples * c * 4 * 2.0), plain_iters=2))
            if b == 1:
                continue
            shapes = [tuple(feats[0].shape)]
            g = randn(n, size, size, c).to(dtype)
            bwd.append(_compare(
                'roi_align_bwd', dtype,
                lambda: roi_align_bwd(shapes, dtype, rois, g, strides, size),
                lambda: multilevel_roi_align_backward(shapes, dtype, rois, g,
                                                      strides, size),
                note, summed=True,
                work=(_nbytes(g, rois) + _nbytes(feats[0]),
                      samples * c * 4 * 2.0), plain_iters=2))
            _check_repeats(shapes, dtype, rois, g, strides, size)
        out[dtype] = (fwd, bwd)
    torch.cuda.empty_cache()
    return out


def htc_serve(name):
    """An HTC config in bf16 through init_detector and inference_detector:
    a warm-up, then HTC_REQUESTS requests at 800x1333, ms a request, peak
    memory, every launch count checked."""
    phase = f'htc-{name}'
    t0 = time.perf_counter()
    model = _htc_model(name)
    per = htc_launches(model, training=False)
    log(phase, f'init_detector: {type(model).__name__} '
               f'{sum(p.numel() for p in model.parameters())} params, '
               f'compute {model.dtype}, {time.perf_counter() - t0:.1f} s; '
               f'launches per request {_nonzero(per)}')
    return _timed_requests(phase, model,
                           synthetic_images(HTC_REQUESTS + 1, seed=9), per,
                           lambda img: inference_detector(model, img),
                           lambda res: _check_result(res, 800, 1333))


def htc_train(name='htc'):
    """1 + HTC_STEPS make_train_step steps (the config in bf16, SGD) at
    batch 2 on the 800x1344 canvas with 16 painted rectangles an image and
    a 1/8-scale stuff map (stuff_maps), each step's launches checked, the
    frozen BN buffers unmoved, a profiled step (busy share)."""
    phase = f'htc-{name}-train'
    cfg = Config.fromfile(HTC_CONFIGS[name])
    cfg.merge_from_dict(RESNET_BF16)
    model = _htc_model(name)
    opt = build_optimizer(model, dict(cfg.optimizer))
    if not isinstance(opt, torch.optim.SGD):
        raise AssertionError(f'{name}: optimizer {type(opt).__name__}')
    step = make_train_step(model, opt, build_lr_schedule(
        dict(cfg.lr_config), cfg.optimizer['lr'], ITERS_PER_EPOCH),
        dict(cfg.optimizer_config).get('grad_clip'))
    per = htc_launches(model, training=True)
    batch = synthetic_train_batch()
    batch['gt_semantic_seg'] = torch.from_numpy(stuff_maps(
        2, (800, 1344), (800, 1333))).cuda()
    gen = torch.Generator(device='cuda').manual_seed(0)
    stats = {k: v.clone() for k, v in model.named_buffers()}
    t0 = time.perf_counter()
    out = step(batch, gen)
    _check_log(out, 'warm-up step')
    torch.cuda.synchronize()
    if 'loss_semantic_seg' not in out:
        raise AssertionError(f'{name}: no semantic loss in {sorted(out)}')
    log(phase, f'warm-up step {time.perf_counter() - t0:.3f} s; launches '
               f'per step {_nonzero(per)}')
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(HTC_STEPS):
        t0 = time.perf_counter()
        out = step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_log(out, 'timed step')
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_launches(phase, launches, per, HTC_STEPS)
    tc = _check_tc(phase, launches, True, (conv3x3, conv3x3_dw))
    moved = [k for k, v in model.named_buffers()
             if not torch.equal(v, stats[k])]
    if moved:
        raise AssertionError(f'{name}: frozen BN buffers moved: {moved[:4]}')
    log(phase, 'per-step ms: ' + ', '.join(f'{t:.1f}' for t in times)
               + f'; peak memory {peak / 2 ** 30:.2f} GiB; last step: '
               + ', '.join(f'{k} {v:.4f}' for k, v in out.items())
               + f'; launches {_nonzero(launches)}, as derived; '
                 f'tensor-core {_nonzero(tc)}; {CARD}')
    busy = _profile_steps(step, batch, gen, float(np.median(times)), phase,
                          n=1)
    return dict(train=launches, times=times, train_peak=peak, busy=busy)


def htc_train_check(device='cuda'):
    """Phase 7's check through phase_train_check on the HTC with its
    semantic branch: fp32 on phase 7's 224x320 batch with a 1/8-scale
    stuff map, the card against the CPU, same seeded weights, batch and
    sampler keys (by call order: each stage's bbox sample, then its
    interleaved mask sample), proposals pinned, CHECK_ROIS rois a stage
    an image; the losses loss_semantic_seg and s{i}.loss_cls, loss_bbox,
    loss_mask, the gradients of HTC_TRAIN_GRADS (the backbone's at
    RESNET_GRAD_LIMIT), each group of loss terms on its own; the bf16
    control must exceed them."""
    batch = train_check_batch()
    batch['gt_semantic_seg'] = stuff_maps(2, (224, 320), (224, 320), seed=2)
    phase_train_check(
        device=device, config=HTC_CONFIGS['htc'], batch=batch,
        names=HTC_TRAIN_GRADS, pin_proposals=True,
        opts=(('bf16', False), *HTC_CHECK_CUTS.items()),
        limits=({}, dict(TOL_TRAIN_GRAD, **{n: RESNET_GRAD_LIMIT
                                            for n in RESNET_BACKBONE_GRADS})))


def write_stuff_maps(root, ann_file):
    """A grayscale PNG stuff map beside each image of ``ann_file``, named
    as the image (CocoDataset's seg_map), in ``root``/stuff: a 4 x 6 grid
    of blocks of labels 0-182 at the image's size. Returns the folder."""
    seg_dir = os.path.join(root, 'stuff')
    os.makedirs(seg_dir, exist_ok=True)
    with open(ann_file) as f:
        images = json.load(f)['images']
    for i, im in enumerate(images):
        h, w = im['height'], im['width']
        seg = stuff_maps(1, (h, w), (h, w), seed=i, stride=1)[0]
        with open(os.path.join(seg_dir, im['file_name']), 'wb') as f:
            f.write(png_bytes(seg))
    return seg_dir + os.sep


def htc_files(name='htc'):
    """From files: train_detector for one epoch (one iteration) on 2 of
    phase 10's PNGs and their grayscale stuff-map PNGs with the config's
    own pipeline (LoadAnnotations with_seg, SegRescale 1/8), then
    tools.test on them with the trained checkpoint, --eval bbox segm,
    score_thr 0: 100 detections an image."""
    phase = f'htc-{name}-files'
    build_dir = os.path.join(REPO, 'build')
    os.makedirs(build_dir, exist_ok=True)
    config = HTC_CONFIGS[name]
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        ann_file, prefix = write_synthetic_coco(root, RESNET_LOOP_SIZES)
        work = os.path.join(root, 'work')
        cfg = loop_config(ann_file, prefix, work, config=config)
        cfg.data.train.seg_prefix = write_stuff_maps(root, ann_file)
        cfg.model.pretrained = None
        model = build_detector(dict(cfg.model, dtype='bfloat16'))
        per = htc_launches(model, training=True)
        reset_launch_counts()
        t0 = time.perf_counter()
        run = train_detector(model, build_dataset(cfg.data.train), cfg)
        torch.cuda.synchronize()
        launches = launch_counts()
        log(phase, f'train_detector: {len(run.log_vars)} iterations in '
                   f'{time.perf_counter() - t0:.1f} s, canvases '
                   f'{run.canvases}; ' + '; '.join(
                       f'loss {v["loss"]:.4g}, loss_semantic_seg '
                       f'{v.get("loss_semantic_seg", float("nan")):.4g}'
                       for v in run.log_vars))
        bad = [v for v in run.log_vars
               if not all(np.isfinite(x) for x in v.values())
               or 'loss_semantic_seg' not in v]
        if len(run.log_vars) != 1 or bad or launches != per:
            raise AssertionError(f'{name}: {len(run.log_vars)} iterations, '
                                 f'non-finite or no semantic loss {bad}, '
                                 f'launches {_nonzero(launches)} (expected '
                                 f'{_nonzero(per)})')
        cfg_file = os.path.join(root, f'{name}_cfg.py')
        eval_config(ann_file, prefix, config=config).dump(cfg_file)
        ran, launches, dets = _cli_run(phase, [
            cfg_file, os.path.join(work, 'epoch_1.pth'), '--samples-per-gpu',
            '2', '--eval', 'bbox', 'segm', '--cfg-options', 'bf16=True',
            'model.test_cfg.rcnn.score_thr=0.0'], 'test')
        want = htc_launches(model, training=False)
        if dets != [100, 100] or launches != want or not all(
                np.isfinite(v) for v in ran['metrics'].values()
                if isinstance(v, float)):
            raise AssertionError(f'{name} test: detections {dets}, launches '
                                 f'{_nonzero(launches)} (expected '
                                 f'{_nonzero(want)}), metrics '
                                 f'{ran["metrics"]}')
        _check_tc(phase, launches, True, (conv3x3,))
        log(phase, f'test: metrics {dict(ran["metrics"])}')


def phase_htc():
    """Phase 20: rows 4 and 9 at the semantic branch's shapes, in bf16 and
    fp32; the HTC with its semantic branch serving, its fp32 serving check
    (phase 12's, a bf16 control), training, its fp32 training check and
    train_detector and tools.test from files; the HTC without it serving
    and its fp32 serving check. Returns each config's results, the kernel
    rows and the phase's seconds."""
    start = last = time.perf_counter()
    laps = []

    def lap(what):
        nonlocal last
        now = time.perf_counter()
        laps.append(f'{what} {now - last:.1f} s')
        log('time', f'htc (phase 20): {laps[-1]}')
        last = now
    gen = torch.Generator().manual_seed(20)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()
    rows = htc_kernel_checks(gen, randn)
    lap('rows 4 and 9 at the semantic shapes')
    out = {}
    for name in HTC_CONFIGS:
        serve, lat, peak, counts = htc_serve(name)
        out[name] = dict(serve=serve, lat=lat, peak=peak, counts=counts)
        lap(f'{name} serving')
        phase_check(phase=f'htc-{name}-check', config=HTC_CONFIGS[name],
                    control=True)
        lap(f'{name} serving check')
        if name != 'htc':
            continue
        out[name].update(htc_train(name))
        lap(f'{name} training')
        htc_train_check()
        lap(f'{name} training check')
        htc_files(name)
        lap(f'{name} files')
    seconds = time.perf_counter() - start
    log('time', 'htc (phase 20): ' + ', '.join(laps) + f'; {seconds:.1f} s')
    return out, rows, seconds


# ------------------------------------------------------------ phase 21
# the RoI-head variants, part 1: Mask Scoring R-CNN, GRoIE, Double-Head
# and Dynamic R-CNN, each a ResNet-50 FPN detector from its config
ROI_CONFIGS = {
    'ms_rcnn': 'configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py',
    'groie': 'configs/groie/mask_rcnn_r50_fpn_groie_1x_coco.py',
    'dh': 'configs/double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py',
    'dynamic': 'configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x.py',
}
ROI_CONFIGS = {k: os.path.join(REPO, v) for k, v in ROI_CONFIGS.items()}
ROI_HEADS = {'ms_rcnn': 'MaskScoringRoIHead', 'groie': 'StandardRoIHead',
             'dh': 'DoubleHeadRoIHead', 'dynamic': 'DynamicRoIHead'}
ROI_REQUESTS = 2
ROI_STEPS = 3
# the training checks' cut (phase 15's): CHECK_ROIS rois an image
ROI_CHECK_CUTS = {'model.train_cfg.rcnn.sampler.num': CHECK_ROIS}
# the gradients the fp32 training checks hold: the ResNet's behind the
# ReLU path (RESNET_GRAD_LIMIT), the neck, the RPN conv and each variant's
# own parts -- the MaskIoU head's conv, first fc and output; GRoIE's
# shared pre conv and attention of both extractors; the Double-Head's
# residual block, a bottleneck's conv and BN and its fc branch; Dynamic
# R-CNN's heads under its adaptive threshold and beta
ROI_HEAD_GRADS = {
    'ms_rcnn': ('roi_head.bbox_head.shared_fcs.0.weight',
                'roi_head.bbox_head.fc_cls.weight',
                'roi_head.mask_head.convs.0.conv.weight',
                'roi_head.mask_iou_head.convs.0.weight',
                'roi_head.mask_iou_head.fcs.0.weight',
                'roi_head.mask_iou_head.fc_mask_iou.weight'),
    'groie': ('roi_head.bbox_roi_extractor.pre_module.conv.weight',
              'roi_head.bbox_roi_extractor.post_module.query_conv.weight',
              'roi_head.bbox_roi_extractor.post_module.proj_conv.weight',
              'roi_head.mask_roi_extractor.pre_module.conv.weight',
              'roi_head.mask_roi_extractor.post_module.value_conv.weight',
              'roi_head.bbox_head.shared_fcs.0.weight',
              'roi_head.mask_head.convs.0.conv.weight'),
    'dh': ('roi_head.bbox_head.res_block.conv1.conv.weight',
           'roi_head.bbox_head.res_block.conv_identity.conv.weight',
           'roi_head.bbox_head.conv_branch.3.conv3.weight',
           'roi_head.bbox_head.conv_branch.0.bn2.weight',
           'roi_head.bbox_head.fc_branch.0.weight',
           'roi_head.bbox_head.fc_cls.weight',
           'roi_head.bbox_head.fc_reg.weight'),
    'dynamic': ('roi_head.bbox_head.shared_fcs.0.weight',
                'roi_head.bbox_head.fc_cls.weight',
                'roi_head.bbox_head.fc_reg.weight'),
}
ROI_TRAIN_GRADS = {name: RESNET_BACKBONE_GRADS + (
    'neck.fpn_convs.0.conv.weight', 'rpn_head.rpn_conv.weight') + heads
    for name, heads in ROI_HEAD_GRADS.items()}
# Limit of the Double-Head's conv-branch gradients in its fp32 training
# check. Its last ReLU, relu(bottleneck + x), over 2 x 128 rois of 7 x 7 x
# 1024 units, holds units within fp32 rounding of zero, and only the
# positives' box loss reaches the branch. On the CPU alone, noise of 1e-7
# of the input moves conv_branch.3.conv3's gradient by 1.58e-2 of its
# largest entry, res_block's by 3.4e-3-5.0e-3; noise of 1e-5 (the card's
# fp32 FPN features differ from the CPU's by 3e-6) moves them by
# 1.5e-2-1.8e-2. The card read 1.58e-2 at conv3, the bf16 control
# 8.7e-2-0.45 (NVIDIA H100 80GB HBM3, 700.00 W). The limit is about twice
# the CPU's own largest movement
ROI_DH_GRAD_LIMIT = 4e-2
ROI_DH_BRANCH = ('roi_head.bbox_head.res_block.',
                 'roi_head.bbox_head.conv_branch.')
# GRoIE's shapes of rows 4 and 9: every roi pooled on every level, the
# finest (P2 of an 800x1344 canvas) the largest
ROI_GROIE_LEVEL = FPN_SHAPES[0]


def _extractor_calls(ext):
    """RoIAlign launches of one call of an extractor: one for a
    SingleRoIExtractor (the levels routed in one launch), one a level for
    GRoIE's."""
    from swindet_tpu_torch.models.roi_heads.roi_extractor import \
        GenericRoIExtractor
    return len(ext.featmap_strides) \
        if isinstance(ext, GenericRoIExtractor) else 1


def roi_launches(model, training):
    """Each kernel's launches that one request (serving) or one step
    (training) of a phase-21 detector makes, derived from the built model:
    a conv3x3 launch per kernel ConvModule of the FPN, per RPN level and
    per mask-head conv pass -- Mask Scoring R-CNN's serving runs its mask
    head twice, the second time for the MaskIoU head --, in training one
    more each for dx and a filter-gradient launch each (GRoIE's 5x5 pre
    convs, the MaskIoU head's convs and the Double-Head's conv branch run
    F.conv2d, as the JAX package runs them outside its kernel); a
    RoIAlign launch per extractor call, GRoIE's one a level, the
    Double-Head's bbox extractor called twice (the rois as they are and
    enlarged), Mask Scoring R-CNN's mask extractor twice a request, in
    training each with its backward; the NMS twice a request and once a
    step."""
    from swindet_tpu_torch.models.roi_heads.double_roi_head import \
        DoubleHeadRoIHead
    from swindet_tpu_torch.models.roi_heads.mask_scoring_roi_head import \
        MaskScoringRoIHead
    roi = model.roi_head
    scoring = isinstance(roi, MaskScoringRoIHead) and not training
    convs = model.rpn_head.conv_uses_kernel \
        * len(model.rpn_head.prior_generator.strides) \
        + sum(c.use_kernel for c in model.neck.fpn_convs)
    aligns = _extractor_calls(roi.bbox_roi_extractor) \
        * (2 if isinstance(roi, DoubleHeadRoIHead) else 1)
    if roi.with_mask:
        convs += sum(c.use_kernel for c in roi.mask_head.convs) \
            * (2 if scoring else 1)
        aligns += _extractor_calls(roi.mask_roi_extractor) \
            * (2 if scoring else 1)
    want = {fn.__name__: 0 for fn in KERNEL_WRAPPERS}
    if training:
        want.update(conv3x3=2 * convs, conv3x3_dw=convs, roi_align=aligns,
                    roi_align_bwd=aligns, nms_sorted=1)
    else:
        want.update(conv3x3=convs, roi_align=aligns, nms_sorted=2)
    return want


def _roi_model(name, device='cuda', seed=0, opts=RESNET_BF16):
    model = init_detector(ROI_CONFIGS[name], device=device, seed=seed,
                          cfg_options=dict(opts))
    if type(model.roi_head).__name__ != ROI_HEADS[name] \
            or type(model.backbone).__name__ != 'ResNet':
        raise AssertionError(f'{name}: not the configured detector')
    return model


def roi_kernel_checks(gen, randn):
    """Rows 4 and 9 at GRoIE's shapes, each against its plain version
    with its bound, in bf16 and fp32: RoIAlign of one level of 200x336x256
    (P2 of an 800x1344 canvas, the largest of the four each roi is pooled
    on) for a training step's 2 x 512 bbox rois at 7x7 and 512 mask rois
    at 14x14 at batch 2, forward and backward, and serving's 1,000
    proposals at 7x7 and 100 detections at 14x14 of one image; each
    case's rois and the work they need, drawn and counted once, serve both
    dtypes. The backward must repeat bit for bit. Returns per dtype the
    forward's and the backward's rows."""
    c, strides = 256, (4,)
    cases = []
    for n, b, size, what in ((1000, 1, 7, 'serving, bbox'),
                             (100, 1, 14, 'serving, mask'),
                             (1024, 2, 7, 'training, bbox'),
                             (512, 2, 14, 'training, mask')):
        rois = _rois(gen, n, batch=b)
        cases.append((n, b, size, rois,
                      _roi_work([ROI_GROIE_LEVEL], rois, strides, size),
                      f'{n} rois {size}x{size}x{c}, one level at stride 4, '
                      f'{ROI_GROIE_LEVEL[0]}x{ROI_GROIE_LEVEL[1]}, batch '
                      f'{b} (GRoIE {what})'))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        el = torch.finfo(dtype).bits // 8
        fwd, bwd = [], []
        for n, b, size, rois, (touched, samples), note in cases:
            feats = [randn(b, *ROI_GROIE_LEVEL, c).to(dtype)]
            fwd.append(_compare(
                'roi_align', dtype,
                lambda: roi_align(feats, rois, strides, size),
                lambda: multilevel_roi_align(feats, rois, strides, size),
                note, work=(touched * c * el + _nbytes(rois)
                            + n * size * size * c * el,
                            samples * c * 4 * 2.0), plain_iters=2))
            if b == 1:
                continue
            shapes = [tuple(feats[0].shape)]
            g = randn(n, size, size, c).to(dtype)
            bwd.append(_compare(
                'roi_align_bwd', dtype,
                lambda: roi_align_bwd(shapes, dtype, rois, g, strides, size),
                lambda: multilevel_roi_align_backward(shapes, dtype, rois, g,
                                                      strides, size),
                note, summed=True,
                work=(_nbytes(g, rois) + _nbytes(feats[0]),
                      samples * c * 4 * 2.0), plain_iters=2))
            _check_repeats(shapes, dtype, rois, g, strides, size)
        out[dtype] = (fwd, bwd)
    torch.cuda.empty_cache()
    return out


def roi_serve(name):
    """A phase-21 config in bf16 through init_detector and
    inference_detector: a warm-up, then ROI_REQUESTS requests at
    800x1333, ms a request, peak memory, every launch count checked."""
    phase = f'roi-{name}'
    t0 = time.perf_counter()
    model = _roi_model(name)
    per = roi_launches(model, training=False)
    log(phase, f'init_detector: {type(model).__name__} with a '
               f'{type(model.roi_head).__name__}, '
               f'{sum(p.numel() for p in model.parameters())} params, '
               f'compute {model.dtype}, {time.perf_counter() - t0:.1f} s; '
               f'launches per request {_nonzero(per)}')
    if model.roi_head.with_mask:
        def check(res):
            return _check_result(res, 800, 1333)
    else:
        def check(res):
            return _check_bbox_result(res, 800, 1344)
    return _timed_requests(phase, model,
                           synthetic_images(ROI_REQUESTS + 1, seed=9), per,
                           lambda img: inference_detector(model, img), check)


def roi_check(name, device='cuda', control=True):
    """Phase 12's fp32 serving check (phase_check) on a phase-21 config,
    with a bf16 control: features, detections, mask probabilities and
    Mask Scoring R-CNN's mask scores, the CPU model's RoI extractors'
    attention drawn (GRoIE)."""
    phase_check(device=device, phase=f'roi-{name}-check',
                config=ROI_CONFIGS[name], control=control)


def roi_train(name):
    """1 + ROI_STEPS make_train_step steps of a phase-21 config (in bf16,
    SGD) at batch 2 on the 800x1344 canvas, each step's launches checked;
    the frozen BN buffers unmoved, the Double-Head's BN running statistics
    moved; Dynamic R-CNN's values advanced once a step; a profiled step
    (busy share) and GRoIE's attention's ms."""
    phase = f'roi-{name}-train'
    cfg = Config.fromfile(ROI_CONFIGS[name])
    cfg.merge_from_dict(RESNET_BF16)
    model = _roi_model(name)
    opt = build_optimizer(model, dict(cfg.optimizer))
    if not isinstance(opt, torch.optim.SGD):
        raise AssertionError(f'{name}: optimizer {type(opt).__name__}')
    step = make_train_step(model, opt, build_lr_schedule(
        dict(cfg.lr_config), cfg.optimizer['lr'], ITERS_PER_EPOCH),
        dict(cfg.optimizer_config).get('grad_clip'))
    per = roi_launches(model, training=True)
    batch = synthetic_train_batch()
    if not model.roi_head.with_mask:
        del batch['gt_masks']
    gen = torch.Generator(device='cuda').manual_seed(0)
    kept = set(model.state_dict())
    stats = {k: v.clone() for k, v in model.named_buffers() if k in kept}
    dynamic = hasattr(model.roi_head, 'iou_hist')
    t0 = time.perf_counter()
    out = step(batch, gen)
    _check_log(out, 'warm-up step')
    torch.cuda.synchronize()
    log(phase, f'warm-up step {time.perf_counter() - t0:.3f} s; launches '
               f'per step {_nonzero(per)}')
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(ROI_STEPS):
        t0 = time.perf_counter()
        out = step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_log(out, 'timed step')
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_launches(phase, launches, per, ROI_STEPS)
    tc = _check_tc(phase, launches, True, (conv3x3, conv3x3_dw))
    moved = {k for k, v in model.named_buffers()
             if k in kept and not torch.equal(v, stats[k])}
    head_bn = {k for k in stats if k.startswith('roi_head.bbox_head.')
               and k.endswith(('running_mean', 'running_var',
                               'num_batches_tracked'))}
    if moved != head_bn or (name == 'dh') != bool(head_bn):
        raise AssertionError(f'{name}: buffers moved {sorted(moved)[:4]}, '
                             f'expected the RoI head\'s BN statistics '
                             f'{sorted(head_bn)[:4]}')
    if dynamic:
        count = int(model.roi_head.count)
        if count != 1 + ROI_STEPS or 'dynamic_beta' not in out:
            raise AssertionError(f'{name}: dynamic count {count} after '
                                 f'{1 + ROI_STEPS} steps; log {sorted(out)}')
    log(phase, 'per-step ms: ' + ', '.join(f'{t:.1f}' for t in times)
               + f'; peak memory {peak / 2 ** 30:.2f} GiB; last step: '
               + ', '.join(f'{k} {v:.4f}' for k, v in out.items())
               + f'; launches {_nonzero(launches)}, as derived; '
                 f'tensor-core {_nonzero(tc)}; {CARD}')
    busy = _profile_steps(step, batch, gen, float(np.median(times)), phase,
                          n=1)
    if dynamic and int(model.roi_head.count) != 2 + ROI_STEPS:
        raise AssertionError(f'{name}: the profiled step did not advance '
                             f'the dynamic values once')
    plugin_ms = _plugin_ms(model, batch, phase)
    return dict(train=launches, times=times, train_peak=peak, busy=busy,
                plugin_ms=plugin_ms)


def roi_train_check(name, device='cuda'):
    """Phase 7's check through phase_train_check on a phase-21 config:
    fp32 on phase 7's 224x320 batch, the card against the CPU, same seeded weights (GRoIE's attention drawn),
    batch and sampler keys, proposals pinned, CHECK_ROIS rois an image;
    the losses (loss_mask_iou, its own gradient group; Dynamic R-CNN's
    logged threshold and beta, both sides at their initial values) and
    the gradients of ROI_TRAIN_GRADS, the backbone's at
    RESNET_GRAD_LIMIT, the Double-Head's conv branch's at
    ROI_DH_GRAD_LIMIT; the bf16 control must exceed them."""
    opts = {'bf16': False, **ROI_CHECK_CUTS}
    cpu = _roi_model(name, device='cpu', seed=1, opts=opts)
    _spread_heads(cpu)
    _draw_roi_plugins(cpu)
    batch = train_check_batch()
    names = ROI_TRAIN_GRADS[name]
    phase_train_check(
        device=device, config=ROI_CONFIGS[name], cpu=cpu, batch=batch,
        names=names, pin_proposals=True, opts=tuple(opts.items()),
        limits=({}, dict(TOL_TRAIN_GRAD, **{n: RESNET_GRAD_LIMIT
                                            for n in RESNET_BACKBONE_GRADS},
                         **{n: ROI_DH_GRAD_LIMIT for n in names
                            if n.startswith(ROI_DH_BRANCH)})))
    if hasattr(cpu.roi_head, 'iou_hist') and int(cpu.roi_head.count) != 1:
        raise AssertionError(f'{name}: the CPU run advanced the dynamic '
                             f'values {int(cpu.roi_head.count)} times')


def phase_roi():
    """Phase 21: rows 4 and 9 at GRoIE's shapes, in bf16 and fp32; then
    each of the four RoI-head variants serving, its fp32 serving check
    (phase 12's, a bf16 control), training and its fp32 training check.
    Returns each config's results, the kernel rows and the phase's
    seconds."""
    start = last = time.perf_counter()
    laps = []

    def lap(what):
        nonlocal last
        now = time.perf_counter()
        laps.append(f'{what} {now - last:.1f} s')
        log('time', f'roi (phase 21): {laps[-1]}')
        last = now
    gen = torch.Generator().manual_seed(21)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()
    rows = roi_kernel_checks(gen, randn)
    lap('rows 4 and 9 at GRoIE\'s shapes')
    out = {}
    for name in ROI_CONFIGS:
        serve, lat, peak, counts = roi_serve(name)
        out[name] = dict(serve=serve, lat=lat, peak=peak, counts=counts)
        lap(f'{name} serving')
        roi_check(name)
        lap(f'{name} serving check')
        out[name].update(roi_train(name))
        lap(f'{name} training')
        roi_train_check(name)
        lap(f'{name} training check')
    seconds = time.perf_counter() - start
    log('time', 'roi (phase 21): ' + ', '.join(laps) + f'; {seconds:.1f} s')
    return out, rows, seconds


# phase 3's further readings of a kernel's main row that the JSON line
# carries: the kernel's own device ms (rows 1, 14 and 15), row 14's
# head-major copy, row 1's first kernel off the vector path, row 15's
# yardsticks' device ms and its blockwise path's ms, and rows 1, 2, 6 and
# 7's readings at Swin-B's shapes
PHASE3_EXTRAS = ('device_ms', 'copy_device_ms', 'first_kernel',
                 'unfused_device_ms', 'blockwise_ms', 'blockwise_device_ms',
                 'swin_b_shapes')


def main() -> int:
    # the default configuration is the config as it stands
    os.environ.pop('SWINDET_FUSED_MLP', None)
    os.environ.pop('SWINDET_WATTN_V4', None)
    start = time.perf_counter()

    def lap(what):
        log('time', f'{what}: {time.perf_counter() - start:.1f} s since '
                    f'the start')
    smi = phase_device()
    phase_build()
    lap('phases 1-2')
    kernels = phase_kernels()
    lap('phase 3')
    runs = {'default': _run_config('default')}
    lap('phases 4-7, default')
    for key, name, switch, flag in (
            ('fused', 'fused', 'SWINDET_FUSED_MLP', 'fused'),
            ('wattn_v4', 'wattn-v4', 'SWINDET_WATTN_V4', 'v4')):
        log(name, f'phases 4-7 again with {switch}=1')
        with env_switch(switch):
            runs[key] = _run_config(name, **{flag: True})
        lap(f'phases 4-7, {name}')
    phase_loop()
    lap('phase 10')
    eval_launches, tta_launches = phase_eval()
    lap('phase 11')
    cascade = phase_cascade()
    lap('phase 12')
    reppoints = phase_reppoints()
    lap('phase 13')
    resnet = phase_resnet()
    lap('phase 14')
    zoo = phase_zoo()
    lap('phase 15')
    backbones, phase16_s = phase_backbones()
    lap('phase 16')
    dense, phase17_s = phase_dense()
    lap('phase 17')
    atss, phase18_s = phase_atss()
    lap('phase 18')
    paa_ld, phase19_s = phase_paa_ld()
    lap('phase 19')
    htc, htc_rows, phase20_s = phase_htc()
    lap('phase 20')
    roi, roi_rows, phase21_s = phase_roi()
    lap('phase 21')
    # phase 20's readings of rows 4 and 9 at the semantic branch's shapes,
    # phase 21's at GRoIE's
    for rows_ in (htc_rows, roi_rows):
        for dtype, (fwd, bwd) in rows_.items():
            for key, new in (('roi_align', fwd), ('roi_align_bwd', bwd)):
                kernels[key][dtype]['shapes'] = \
                    kernels[key][dtype].get('shapes', []) + new
    for what, key, fmt in (('request latency (s)', 'lat', '.4f'),
                           ('training step (ms)', 'times', '.1f')):
        log('configs', f'{what}, median of the timed runs: ' + ', '.join(
            f'{c} {np.median(r[key]):{fmt}}' for c, r in runs.items()))
    log('configs', 'training peak memory (GiB): ' + ', '.join(
        f'{c} {r["peak"] / 2 ** 30:.2f}' for c, r in runs.items()))
    log('configs', 'training busy share: ' + ', '.join(
        f'{c} {r["busy"]:.3f}' for c, r in runs.items()))
    log('cascade', f'Cascade Mask R-CNN Swin-B: request latency median '
                   f'{np.median(cascade["lat"]):.4f} s, training step median '
                   f'{np.median(cascade["times"]):.1f} ms, peak '
                   f'{cascade["peak"] / 2 ** 30:.2f} GiB, busy '
                   f'{cascade["busy"]:.3f}; {smi}')
    log('reppoints', f'RepPoints-moment Swin-T: request latency median '
                     f'{np.median(reppoints["lat"]):.4f} s, training step '
                     f'median {np.median(reppoints["times"]):.1f} ms, peak '
                     f'{reppoints["peak"] / 2 ** 30:.2f} GiB, busy '
                     f'{reppoints["busy"]:.3f}, deformable convs '
                     f'{reppoints["deform"][0]:.2f} + '
                     f'{reppoints["deform"][1]:.2f} ms a step; {smi}')
    for which, name in (('faster', 'Faster R-CNN R-50'),
                        ('retina', 'RetinaNet R-50')):
        r = resnet[which]
        kernel_ms, ours, lib = r['split']
        log(which, f'{name}: request latency median '
                   f'{np.median(r["lat"]):.4f} s, training step median '
                   f'{np.median(r["times"]):.1f} ms, peak '
                   f'{r["peak"] / 2 ** 30:.2f} GiB, busy {r["busy"]:.3f}, '
                   f'kernel {kernel_ms:.1f} ms a step (hand-written '
                   f'{ours:.2f}, library convolutions and GEMMs '
                   f'{lib:.2f}); {smi}')
    for name, r in zoo.items():
        log('zoo', f'{name}: request latency median '
                   f'{np.median(r["lat"]):.4f} s'
                   + ('' if 'times' not in r else
                      f', training step median {np.median(r["times"]):.1f}'
                      f' ms, peak {r["peak"] / 2 ** 30:.2f} GiB, busy '
                      f'{r["busy"]:.3f}, plain deformable ops '
                      f'{r["deform_ms"]:.2f} ms a step') + f'; {smi}')
    for name, r in backbones.items():
        log('backbones', f'{name}: request latency median '
                         f'{np.median(r["lat"]):.4f} s'
                         + ('' if 'times' not in r else
                            f', training step median '
                            f'{np.median(r["times"]):.1f} ms, peak '
                            f'{r["peak"] / 2 ** 30:.2f} GiB, busy '
                            f'{r["busy"]:.3f}, plugins (plain torch) '
                            f'{r["plugin_ms"][0]:.2f} ms a step, kernels '
                            f'{r["plugin_ms"][1]:.2f} ms of it')
                         + f'; {smi}')
    log('backbones', f'phase 16 {phase16_s:.1f} s')
    for name, r in dense.items():
        log('dense', f'{name}: request ms median '
                     f'{np.median(r["lat"]) * 1e3:.1f}, serving peak '
                     f'{r["peak"] / 2 ** 30:.2f} GiB'
                     + ('' if 'times' not in r else
                        f', training step median {np.median(r["times"]):.1f}'
                        f' ms, peak {r["train_peak"] / 2 ** 30:.2f} GiB, '
                        f'busy {r["busy"]:.3f}'
                        + (f', plain deformable convs {r["deform_ms"]:.2f} '
                           f'ms a step' if r['deform_ms'] else ''))
                     + f'; {smi}')
    log('dense', f'phase 17 {phase17_s:.1f} s')
    for name, r in atss.items():
        log('atss', f'{name}: request ms median '
                    f'{np.median(r["lat"]) * 1e3:.1f}, serving peak '
                    f'{r["peak"] / 2 ** 30:.2f} GiB, training step median '
                    f'{np.median(r["times"]):.1f} ms, peak '
                    f'{r["train_peak"] / 2 ** 30:.2f} GiB, busy '
                    f'{r["busy"]:.3f}'
                    + (f', plain deformable convs {r["deform_ms"]:.2f} ms '
                       f'a step' if r['deform_ms'] else '') + f'; {smi}')
    log('atss', f'phase 18 {phase18_s:.1f} s')
    for name, r in paa_ld.items():
        log('paa-ld', f'{name}: request ms median '
                      f'{np.median(r["lat"]) * 1e3:.1f}, serving peak '
                      f'{r["peak"] / 2 ** 30:.2f} GiB, training step median '
                      f'{np.median(r["times"]):.1f} ms, peak '
                      f'{r["train_peak"] / 2 ** 30:.2f} GiB, busy '
                      f'{r["busy"]:.3f}'
                      + ('' if r['em'] is None else
                         f', the EM {r["em"]["ms"]:.2f} ms a step with '
                         f'{r["em"]["reads"]} host reads') + f'; {smi}')
    log('paa-ld', f'phase 19 {phase19_s:.1f} s')
    for name, r in htc.items():
        log('htc', f'{name}: request ms median '
                   f'{np.median(r["lat"]) * 1e3:.1f}, serving peak '
                   f'{r["peak"] / 2 ** 30:.2f} GiB'
                   + ('' if 'times' not in r else
                      f', training step median {np.median(r["times"]):.1f}'
                      f' ms, peak {r["train_peak"] / 2 ** 30:.2f} GiB, '
                      f'busy {r["busy"]:.3f}') + f'; {smi}')
    log('htc', f'phase 20 {phase20_s:.1f} s')
    for name, r in roi.items():
        log('roi', f'{name}: request ms median '
                   f'{np.median(r["lat"]) * 1e3:.1f}, serving peak '
                   f'{r["peak"] / 2 ** 30:.2f} GiB, training step median '
                   f'{np.median(r["times"]):.1f} ms, peak '
                   f'{r["train_peak"] / 2 ** 30:.2f} GiB, busy '
                   f'{r["busy"]:.3f}'
                   + (f', RoI extractors\' attention (plain torch) '
                      f'{r["plugin_ms"][0]:.2f} ms a step, kernels '
                      f'{r["plugin_ms"][1]:.2f} ms of it'
                      if r['plugin_ms'][0] else '') + f'; {smi}')
    log('roi', f'phase 21 {phase21_s:.1f} s')
    rows = []
    for fn in KERNEL_WRAPPERS:
        name = fn.__name__
        # NMS takes fp32 boxes in both configurations
        fp32 = kernels[name][torch.float32]
        main_row = kernels[name].get(torch.bfloat16, fp32)
        counts, tc = {}, {}
        for c, r in runs.items():
            pre = '' if c == 'default' else f'{c}_'
            counts[f'{pre}serve_launches'] = r['serve'][name]
            counts[f'{pre}train_launches'] = r['train'][name]
            if fn in TENSOR_CORE_KERNELS:
                tc[f'{pre}serve_tc_launches'] = r['serve_tc'][name]
                tc[f'{pre}train_tc_launches'] = r['train_tc'][name]
        # phase 11's test and test-time augmentation runs
        counts['eval_launches'] = eval_launches[name]
        counts['tta_launches'] = tta_launches[name]
        # phase 12's cascade: 3 requests, 5 steps
        counts['cascade_serve_launches'] = cascade['serve'][name]
        counts['cascade_train_launches'] = cascade['train'][name]
        # phase 13's RepPoints: 3 requests, 5 steps
        counts['reppoints_serve_launches'] = reppoints['serve'][name]
        counts['reppoints_train_launches'] = reppoints['train'][name]
        # phase 14's ResNet-50 detectors: 3 requests, 5 steps each
        for which in ('faster', 'retina'):
            counts[f'{which}_serve_launches'] = resnet[which]['serve'][name]
            counts[f'{which}_train_launches'] = resnet[which]['train'][name]
        # phase 15's zoo and phase 16's backbones: 2 requests each, 3
        # steps of the four of each that train
        for which, r in {**zoo, **backbones}.items():
            counts[f'{which}_serve_launches'] = r['serve'][name]
            if 'train' in r:
                counts[f'{which}_train_launches'] = r['train'][name]
        # phase 17's dense configs: 2 requests each, 3 steps of the five
        # that train
        for which, r in dense.items():
            counts[f'dense_{which}_serve_launches'] = r['serve'][name]
            if 'train' in r:
                counts[f'dense_{which}_train_launches'] = r['train'][name]
        # phase 18's ATSS line: 2 requests and 3 steps each
        for which, r in atss.items():
            counts[f'atss_{which}_serve_launches'] = r['serve'][name]
            counts[f'atss_{which}_train_launches'] = r['train'][name]
        # phase 19's PAA and LD: 2 requests and 3 steps each
        for which, r in paa_ld.items():
            counts[f'paa_ld_{which}_serve_launches'] = r['serve'][name]
            counts[f'paa_ld_{which}_train_launches'] = r['train'][name]
        # phase 20's HTCs: 2 requests each, 3 steps of the one with the
        # semantic branch
        for which, r in htc.items():
            counts[f'htc_{which}_serve_launches'] = r['serve'][name]
            if 'train' in r:
                counts[f'htc_{which}_train_launches'] = r['train'][name]
        # phase 21's RoI-head variants: 2 requests and 3 steps each
        for which, r in roi.items():
            counts[f'roi_{which}_serve_launches'] = r['serve'][name]
            counts[f'roi_{which}_train_launches'] = r['train'][name]
        if tc:
            tc = dict(tc_launches=sum(tc.values()), **tc)
        if 'shapes' in main_row:
            # the bf16 rows (NMS: fp32): every shape of the main path
            tc['shapes'] = main_row['shapes']
        rows.append(dict(
            name=name, route='cuda', **KERNELS[name],
            launches=sum(counts.values()), **counts, **tc,
            dtype='float32' if main_row is fp32 else 'bfloat16',
            shape=main_row['shape'], max_abs_err=main_row['max_abs_err'],
            ms=main_row['ms'], plain_ms=main_row['plain_ms'],
            bound_ms=main_row['bound_ms'], bound_by=main_row['bound_by'],
            library_ms=main_row['library_ms'],
            unfused_ms=main_row.get('unfused_ms'),
            fp32_max_abs_err=fp32['max_abs_err'], fp32_ms=fp32['ms'],
            fp32_plain_ms=fp32['plain_ms'],
            fp32_library_ms=fp32['library_ms'],
            **{k: main_row[k] for k in PHASE3_EXTRAS if k in main_row}))
    print(json.dumps({'kernels': rows}), flush=True)
    print(smi, flush=True)
    # the run uses one card, cuda:0, whatever the host exposes
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': 1}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
