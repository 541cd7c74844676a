// Kernel 14's compile-time tableaux (csrc/fleet_scan.cu instances them): each
// adaptive tableau (integrators/methods.py ADAPTIVE_METHODS), every coefficient
// the f64 value integrators/methods.py evaluates from its exact fraction in
// integrators/tableaux.py, as a hex-float literal.  ERK: c, a, b, e; ERKNG:
// c, a (ap), av, b (bp), bv, e (ep), ev.  Written by
// tools/gen_fleet_tableaux.py; do not edit by hand.

#pragma once

namespace tableau {

struct CashKarp45 {
  static constexpr int kStages = 6;
  static constexpr bool kNystrom = false;
  static constexpr double kC[6] = {0x0.0p+0, 0x1.999999999999ap-3, 0x1.3333333333333p-2, 0x1.3333333333333p-1, 0x1.0000000000000p+0, 0x1.c000000000000p-1};
  static constexpr double kA[6][6] = {{},
      {0x1.999999999999ap-3},
      {0x1.3333333333333p-4, 0x1.ccccccccccccdp-3},
      {0x1.3333333333333p-2, -0x1.ccccccccccccdp-1, 0x1.3333333333333p+0},
      {-0x1.a12f684bda12fp-3, 0x1.4000000000000p+1, -0x1.4bda12f684bdap+1, 0x1.4bda12f684bdap+0},
      {0x1.e3425ed097b42p-6, 0x1.5e00000000000p-2, 0x1.54bda12f684bep-5, 0x1.99f425ed097b4p-2, 0x1.fa00000000000p-5}};
  static constexpr double kB[6] = {0x1.a284bda12f685p-4, 0x0.0p+0, 0x1.891f2747c9d1fp-2, 0x1.f4ed097b425edp-3, 0x1.3c92492492492p-6, 0x1.0000000000000p-2};
  static constexpr double kE[6] = {0x1.1965965965966p-8, 0x0.0p+0, -0x1.31ddb9af1560ap-6, 0x1.17cc48676f312p-5, 0x1.3c92492492492p-6, -0x1.405342ed5a583p-5};
};

struct DormandPrince54 {
  static constexpr int kStages = 7;
  static constexpr bool kNystrom = false;
  static constexpr double kC[7] = {0x0.0p+0, 0x1.999999999999ap-3, 0x1.3333333333333p-2, 0x1.999999999999ap-1, 0x1.c71c71c71c71cp-1, 0x1.0000000000000p+0, 0x1.0000000000000p+0};
  static constexpr double kA[7][7] = {{},
      {0x1.999999999999ap-3},
      {0x1.3333333333333p-4, 0x1.ccccccccccccdp-3},
      {0x1.f49f49f49f49fp-1, -0x1.ddddddddddddep+1, 0x1.c71c71c71c71cp+1},
      {0x1.79eec0fc37181p+1, -0x1.7310bd29520e4p+3, 0x1.3a552363c5290p+3, -0x1.29c9eba1e3345p-2},
      {0x1.6c52bf5a814b0p+1, -0x1.583e0f83e0f84p+3, 0x1.1d016a3721e8bp+3, 0x1.1d1745d1745d1p-2, -0x1.1818970d9cc2fp-2},
      {0x1.7555555555555p-4, 0x0.0p+0, 0x1.cc0499a5605fbp-2, 0x1.4d55555555555p-1, -0x1.4a1cfb2b78c13p-2, 0x1.0c30c30c30c31p-3}};
  static constexpr double kB[7] = {0x1.7555555555555p-4, 0x0.0p+0, 0x1.cc0499a5605fbp-2, 0x1.4d55555555555p-1, -0x1.4a1cfb2b78c13p-2, 0x1.0c30c30c30c31p-3, 0x0.0p+0};
  static constexpr double kE[7] = {0x1.4320fedcba987p-10, 0x0.0p+0, -0x1.16b5a550abfc4p-8, 0x1.2eeeeeeeeeeefp-5, -0x1.a0ad1d2ca1858p-5, 0x1.5748a7bdaf0e2p-5, -0x1.999999999999ap-6};
};

struct DormandPrince87 {
  static constexpr int kStages = 13;
  static constexpr bool kNystrom = false;
  static constexpr double kC[13] = {0x0.0p+0, 0x1.c71c71c71c71cp-5, 0x1.5555555555555p-4, 0x1.0000000000000p-3, 0x1.4000000000000p-2, 0x1.8000000000000p-2, 0x1.2e147ae147ae1p-3, 0x1.dc28f5c28f5c3p-2, 0x1.21360b60a7776p-1, 0x1.4cccccccccccdp-1, 0x1.d96c8c31039dbp-1, 0x1.0000000000000p+0, 0x1.0000000000000p+0};
  static constexpr double kA[13][13] = {{},
      {0x1.c71c71c71c71cp-5},
      {0x1.5555555555555p-6, 0x1.0000000000000p-4},
      {0x1.0000000000000p-5, 0x0.0p+0, 0x1.8000000000000p-4},
      {0x1.4000000000000p-2, 0x0.0p+0, -0x1.2c00000000000p+0, 0x1.2c00000000000p+0},
      {0x1.3333333333333p-5, 0x0.0p+0, 0x0.0p+0, 0x1.8000000000000p-3, 0x1.3333333333333p-3},
      {0x1.887ad701404acp-5, 0x0.0p+0, 0x0.0p+0, 0x1.cbc54e6660e1dp-4, -0x1.a1e28caf3b65cp-6, 0x1.a4f6f83ae9731p-7},
      {0x1.152f31366e4d8p-6, 0x0.0p+0, 0x0.0p+0, 0x1.8d28195fa13c2p-2, 0x1.26ba035d10b6dp-5, 0x1.93651ea2bd3c4p-3, -0x1.61b7ccdaf2f38p-3},
      {0x1.1b04260f85fe2p-4, 0x0.0p+0, 0x0.0p+0, -0x1.44bc269b358ddp-1, -0x1.4a21f44e45fd3p-3, 0x1.1bf4b185a5c0bp-3, 0x1.e1c165324ef0ap-1, 0x1.b16e62e7158fcp-3},
      {0x1.77ecbb1301621p-3, 0x0.0p+0, 0x0.0p+0, -0x1.3c0097b3c5a32p+1, -0x1.2a471c23b2d29p-2, -0x1.b1bbe5082a5c1p-6, 0x1.6c85fb0a3e9bfp+1, 0x1.20240028afd67p-2, 0x1.fadbee9f5b0f4p-4},
      {-0x1.372614b1764cfp+0, 0x0.0p+0, 0x0.0p+0, 0x1.0ac3014df3e48p+4, 0x1.d4dc1ce9424acp-1, -0x1.839f6df39ea9cp+2, -0x1.000ea32f607acp+4, 0x1.db2d7daa814a6p+3, -0x1.abe3f2cbe1d36p+3, 0x1.489672d167d27p+2},
      {0x1.0912d609427e0p-2, 0x0.0p+0, 0x0.0p+0, -0x1.31912cd3f9270p+2, -0x1.bd8905e38fcd7p-2, -0x1.865578467943fp+1, 0x1.64fca455cea0cp+2, 0x1.89f9250f88c23p+2, -0x1.43f985843ddf3p+2, 0x1.18d292a5d3212p+1, 0x1.13b7d81af1344p-3},
      {0x1.a5153af7727fdp-1, 0x0.0p+0, 0x0.0p+0, -0x1.7513d9f0583c5p+3, -0x1.83e70bcbd3e65p-1, 0x1.6d8df236b4d37p-1, 0x1.826cbfaa51862p+3, -0x1.10572243a9883p+1, 0x1.fd7b8854e12f5p+0, -0x1.dfd195e96a441p-3, 0x1.683d837559248p-3, 0x0.0p+0}};
  static constexpr double kB[13] = {0x1.55fed5a492d16p-5, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, -0x1.c643f63bea075p-5, 0x1.ea1cd5438b4f0p-3, 0x1.68328ceaf3204p-1, -0x1.84ff364c4f34cp-1, 0x1.5235514d8405cp-1, 0x1.43f7cc8023f22p-3, -0x1.e7a5f94e7938dp-3, 0x1.0000000000000p-2};
  static constexpr double kE[13] = {0x1.8f950374a4f38p-7, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x1.8bdad591ce63bp-1, -0x1.269e126744244p-4, -0x1.c38aa8c018342p+0, 0x1.c984c3155396ap+0, -0x1.90e37b7ca45bcp-1, 0x1.42a64f4ea6f19p-4, -0x1.2155d4d4bf749p-2, 0x1.0000000000000p-2};
};

struct Fehlberg45 {
  static constexpr int kStages = 6;
  static constexpr bool kNystrom = false;
  static constexpr double kC[6] = {0x0.0p+0, 0x1.0000000000000p-2, 0x1.8000000000000p-2, 0x1.d89d89d89d89ep-1, 0x1.0000000000000p+0, 0x1.0000000000000p-1};
  static constexpr double kA[6][6] = {{},
      {0x1.0000000000000p-2},
      {0x1.8000000000000p-4, 0x1.2000000000000p-2},
      {0x1.c23e39189614cp-1, -0x1.a37b2a108bd3cp+1, 0x1.a912fe408db10p+1},
      {0x1.0425ed097b426p+1, -0x1.0000000000000p+3, 0x1.cb1a72c69cb1ap+2, -0x1.a5ad296b4a5adp-3},
      {-0x1.2f684bda12f68p-2, 0x1.0000000000000p+1, -0x1.61b58ba0961b6p+0, 0x1.cfd813f604fd8p-2, -0x1.199999999999ap-2}};
  static constexpr double kB[6] = {0x1.da12f684bda13p-4, 0x0.0p+0, 0x1.190d13101190dp-1, 0x1.1216f485bd217p-1, -0x1.999999999999ap-3, 0x0.0p+0};
  static constexpr double kE[6] = {0x1.6c16c16c16c17p-9, 0x0.0p+0, -0x1.ea8fd6cceb75dp-6, -0x1.de693b17fafdep-6, 0x1.47ae147ae147bp-6, 0x1.29e4129e4129ep-5};
};

struct Tsitouras75 {
  static constexpr int kStages = 9;
  static constexpr bool kNystrom = false;
  static constexpr double kC[9] = {0x0.0p+0, 0x1.c71c71c71c71cp-5, 0x1.c71c71c71c71cp-4, 0x1.5555555555555p-3, 0x1.c7ae147ae147bp-2, 0x1.f6a2404cbebb8p-2, 0x1.8ed2308158ed2p-1, 0x1.c71c71c71c71cp-1, 0x1.0000000000000p+0};
  static constexpr double kA[9][9] = {{},
      {0x1.c71c71c71c71cp-5},
      {0x0.0p+0, 0x1.c71c71c71c71cp-4},
      {0x1.5555555555555p-5, 0x0.0p+0, 0x1.0000000000000p-3},
      {0x1.178c5c9a34ca1p-1, 0x0.0p+0, -0x1.0ae7f0aa21a72p+1, 0x1.fbf53825e13b2p+0},
      {0x1.7dd3f7c47b89dp-4, 0x0.0p+0, -0x1.0788d27fea11dp-2, 0x1.05f61d3d476ecp-1, 0x1.2593b4c1f61aep-3},
      {-0x1.6aeadacd7a614p+0, 0x0.0p+0, 0x1.5ab92aaf83d4dp+2, -0x1.d90de97158bfcp+1, -0x1.d6dd657393da4p+0, 0x1.283440532e6f2p+1},
      {0x1.01c05fdaf43d6p+2, 0x0.0p+0, -0x1.bc999c8be9c3fp+3, 0x1.3a4dc57ccef98p+3, 0x1.bcb66e3613a4bp+2, -0x1.a50b2bd5eb679p+2, 0x1.207cd0dfe5453p-1},
      {-0x1.d1e5a38192aeep+1, 0x0.0p+0, 0x1.865eebae5a1f7p+3, -0x1.e528ef241872bp+2, -0x1.0c624c81f85ebp+3, 0x1.0eef25c106484p+3, -0x1.50afc579837fap-2, 0x1.14f3361a9f007p-2}};
  static constexpr double kB[9] = {0x1.8bdfdd33f7431p-5, 0x0.0p+0, 0x0.0p+0, 0x1.0c82709e29e22p-2, 0x1.f5ca75ab73046p-5, 0x1.20370e60a261ap-2, 0x1.9af3c8d4de8fap-3, 0x1.a81fbe3a57f15p-4, 0x1.5c7b15620979ap-5};
  static constexpr double kE[9] = {0x1.1f69b46c77236p-6, 0x0.0p+0, 0x0.0p+0, -0x1.105a5139c09c3p-4, 0x1.0cebae0a543cbp-1, -0x1.0e94f1e1ce12cp-1, 0x1.67077121e0f14p-4, -0x1.227adc8ededa2p-5, 0x0.0p+0};
};

struct Verner87 {
  static constexpr int kStages = 13;
  static constexpr bool kNystrom = false;
  static constexpr double kC[13] = {0x0.0p+0, 0x1.0000000000000p-2, 0x1.ce641ef0bd4c3p-4, 0x1.5acb17348df92p-3, 0x1.b22d0e5604189p-2, 0x1.049ba5e353f7dp-1, 0x1.bbe76c8b43958p-1, 0x1.3333333333333p-3, 0x1.6b0af736ee976p-1, 0x1.47ae147ae147bp-2, 0x1.ccccccccccccdp-2, 0x1.0000000000000p+0, 0x1.0000000000000p+0};
  static constexpr double kA[13][13] = {{},
      {0x1.0000000000000p-2},
      {0x1.65fe6e1619ea3p-4, 0x1.a196c36a8d881p-6},
      {0x1.5acb17348df92p-5, 0x0.0p+0, 0x1.041851676a7aep-3},
      {0x1.b452435ba27b8p-2, 0x0.0p+0, -0x1.994aa5d49c2d8p+0, 0x1.98c158933494dp+0},
      {0x1.9f7e28deda8ebp-5, 0x0.0p+0, 0x0.0p+0, 0x1.0470128f21ad2p-2, 0x1.a1aee83755e16p-3},
      {-0x1.28f6be07571c9p-2, 0x0.0p+0, 0x0.0p+0, 0x1.581caa34270f1p+0, -0x1.6eb10b2c850f9p+1, 0x1.56bb68f62d510p+1},
      {0x1.939972b3529f5p-4, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x1.c6818fb9926ddp-3, -0x1.73851bead2855p-3, 0x1.66a060ac9fb09p-7},
      {0x1.8c66b39b1b2a3p-2, 0x0.0p+0, 0x0.0p+0, -0x1.71441badf6799p+0, 0x1.73e4167df4df4p+1, -0x1.da90bda6550dfp+0, 0x1.1ecb7250b2ca6p-3, 0x1.253e1985f7e18p-1},
      {-0x1.4a3a4ff4e8fe1p-3, 0x0.0p+0, 0x0.0p+0, -0x1.631d752232d36p-3, -0x1.4d214b5a46bd0p+0, 0x1.2350b73dd7b90p+0, -0x1.0413a5a102e49p-5, 0x1.ddf5686858f83p-1, -0x1.57305291994d2p-4},
      {-0x1.3a904ef789bc0p-6, 0x0.0p+0, 0x0.0p+0, 0x1.17de33d509c52p-2, -0x1.59c770a93384ep-1, 0x1.5db70671ef552p-2, -0x1.1652cea1771c3p-4, 0x1.8ba3cb0f78563p-4, 0x1.0f6c523c898ecp-3, 0x1.7965108dee423p-2},
      {0x1.37e7749bfac5ep-1, 0x0.0p+0, 0x0.0p+0, -0x1.22e38b36ea907p+1, 0x1.3081680ce40fap+2, -0x1.6107e46c9f776p+2, 0x1.290564baab41fp-2, 0x1.2366a1d60f3eep-1, 0x1.95da18ee8a24bp-1, 0x1.3ce6dc078bb5dp-3, 0x1.9d6ebb8cdc63dp+0},
      {0x1.c653bcfd6d006p-1, 0x0.0p+0, 0x0.0p+0, -0x1.7cdbddbb5c170p+1, 0x1.667225c179c3ep+2, -0x1.7a994ffe01da6p+2, 0x1.c32b044554e59p-3, 0x1.9ff3eb26ffd5cp-4, 0x1.26c46a67094b5p+0, 0x1.ee017c47fe225p+0, 0x0.0p+0, 0x0.0p+0}};
  static constexpr double kB[13] = {0x1.6e6cb22d0c7eap-5, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x1.415a34b35b0f1p-3, 0x1.7a14ab133a19cp-3, 0x1.cd22ae78d1f83p-3, 0x1.2efe64fe91725p-3, 0x1.37860437b0a40p-4, 0x1.f6e0b806dd64ep-4, 0x1.5686085df522ap-5, 0x0.0p+0};
  static constexpr double kE[13] = {-0x1.24f54ab195efep-10, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, -0x1.afc0e7e82d8a0p-4, -0x1.d0419e5b1a5a8p-8, 0x1.088189b18379cp-7, 0x1.50ecc2553e9a4p-6, -0x1.3fe5490557b92p-5, 0x1.f6e0b806dd64ep-4, 0x1.5686085df522ap-5, -0x1.4c47450c0d4ffp-5};
};

struct Verner98 {
  static constexpr int kStages = 16;
  static constexpr bool kNystrom = false;
  static constexpr double kC[16] = {0x0.0p+0, 0x1.1b9b66f9335d2p-5, 0x1.8d6967ce8c13fp-4, 0x1.2a0f0ddae90f0p-3, 0x1.1f3b645a1cac1p-1, 0x1.d5021996737dep-3, 0x1.170933f898600p-1, 0x1.4a3d70a3d70a4p-1, 0x1.ef5c28f5c28f6p-2, 0x1.14c447c30d307p-4, 0x1.0000000000000p-2, 0x1.5170f9cd5cc3bp-1, 0x1.a425aee631f8ap-1, 0x1.cd6a161e4f766p-1, 0x1.0000000000000p+0, 0x1.0000000000000p+0};
  static constexpr double kA[16][16] = {{},
      {0x1.1b9b66f9335d2p-5},
      {-0x1.3ef18f369c599p-5, 0x1.167117b4ed206p-3},
      {0x1.2a0f0ddae90f0p-5, 0x0.0p+0, 0x1.bf1694c85d967p-4},
      {0x1.034c3b60de990p+1, 0x0.0p+0, -0x1.e8d561edf47b5p+2, 0x1.8b16b0c8c8c45p+2},
      {0x1.a2cc3094af286p-5, 0x0.0p+0, 0x0.0p+0, 0x1.6aaa2aa3ac882p-3, 0x1.a4e2cd9b2baabp-11},
      {0x1.0d84a25710b76p-3, 0x0.0p+0, 0x0.0p+0, -0x1.2ed338fc2e70dp-2, 0x1.67af6c2c4dca9p-4, 0x1.3e1bba5b61b14p-1},
      {0x1.258bf258bf259p-4, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x1.527c9456e8906p-2, 0x1.f136a0b52b757p-3},
      {0x1.261eb851eb852p-4, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x1.515833d6d2263p-2, 0x1.dd4307aef4d7ep-4, -0x1.16a3d70a3d70ap-5},
      {0x1.8c3a28e31b86bp-5, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x1.41dce40bdea02p-5, 0x1.b0059aad5ca01p-4, -0x1.5f403a3623eb5p-6, -0x1.aa7ccad443883p-4},
      {-0x1.b48fcf1d415e2p-6, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x1.1111111111111p-5, -0x1.4e0b29174ffc1p-3, 0x1.1634feb5b82f1p-5, 0x1.4202d1f0f5b35p-3, 0x1.b8c8cd1850248p-3},
      {0x1.2e342198e9115p-5, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, -0x1.2c11b63bca539p-3, 0x1.cb47a94a6dac6p-3, 0x1.77ea59cbdfec0p-6, -0x1.d5e4d0f53f286p-9, 0x1.6317652422c98p-4, 0x1.c0e7c09c6e85fp-2},
      {-0x1.f247973256de1p-2, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, -0x1.937e9c1d4f589p+2, -0x1.1ffed9f2c94d6p-2, -0x1.56ea1a3275a6cp+1, 0x1.09a234ea69df9p-1, 0x1.5d87c9583ee69p+0, 0x1.78a55517c6c06p+2, 0x1.66c27034fd6f7p+1},
      {0x1.ac94e58d1e166p-2, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x1.ae5efcd22bc8bp+2, -0x1.b3a7aa564f1fap-2, 0x1.abf0923fc4fe8p+1, 0x1.3bf220b41a2bap-1, -0x1.dc2485116b774p-1, -0x1.86658fabeb833p+2, -0x1.80484ad86ab9fp+1, 0x1.0572ac219c10cp-2},
      {-0x1.8f0a1ec67ecf8p-1, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, -0x1.bdfeb5c74a523p+3, 0x1.4086460e42362p+0, -0x1.d620c576b34cbp+3, -0x1.fa93f67e432f1p-2, 0x1.1f19cd44440d6p+1, 0x1.abc5c939fb0acp+3, 0x1.ccb15c5c836e1p+3, -0x1.985c949bcbe2ep-1, 0x1.c3848fd794123p-2},
      {0x1.076e39e9f4652p+1, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x1.65ba1ce93a093p+4, 0x1.d1a9bc7c3cdabp-1, 0x1.1f20f98d46d29p+5, -0x1.b8a45519d15a3p+1, -0x1.37640bec04167p+2, -0x1.2e8e8e718f1f2p+4, -0x1.121bbd355f980p+5, 0x1.43c7155a15e35p+0, 0x0.0p+0, 0x0.0p+0}};
  static constexpr double kB[16] = {0x1.dece255e50a69p-7, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, -0x1.90eaee0a3fef2p-2, 0x1.d9476af99b058p-3, 0x1.05127df5b7ad1p-3, 0x1.cc11d91f87e5ap-3, 0x1.2309f29447a78p-1, 0x1.dd4161c2dc3f7p-5, 0x1.1769863774af7p-3, 0x1.f4dc75b3aef35p-6, 0x0.0p+0};
  static constexpr double kE[16] = {-0x1.5f24207ad4dafp-8, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, 0x0.0p+0, -0x1.4aa06a5b4365ap+1, 0x1.23e2da5f7ecf5p-3, 0x1.b7c499f6c6ea1p-7, -0x1.d5c71f7fb5980p-6, 0x1.4ffffd1b94e09p+1, -0x1.21550a3cfce7cp-2, 0x1.1769863774af7p-3, 0x1.f4dc75b3aef35p-6, -0x1.8c052e109946dp-5};
};

struct Fine45 {
  static constexpr int kStages = 7;
  static constexpr bool kNystrom = true;
  static constexpr double kC[7] = {0x0.0p+0, 0x1.a41a41a41a41ap-3, 0x1.3b13b13b13b14p-2, 0x1.aaaaaaaaaaaabp-1, 0x1.d46cefa8d9df5p-1, 0x1.0000000000000p+0, 0x1.0000000000000p+0};
  static constexpr double kA[7][7] = {{},
      {0x1.58b31509ee28cp-6},
      {0x1.83c977ab2beddp-6, 0x1.83c977ab2beddp-6},
      {0x1.148b0fcd6e9e0p-5, 0x0.0p+0, 0x1.40fcd6e9e0652p-2},
      {-0x1.f356d94d01628p-5, 0x1.2a9a56c51d4e0p-3, 0x1.5f4df35feab7fp-2, -0x1.3420c953ef831p-7},
      {-0x1.15fdb8ebeee0ep-3, 0x1.6970820fc9562p-2, 0x1.136b3ef31489cp-2, 0x1.c4636e633211bp-7, 0x0.0p+0},
      {0x1.7e5f6a217f904p-4, 0x0.0p+0, 0x1.473b587ebfe1ap-2, 0x1.1c9775f5fcf01p-3, -0x1.a8f77010f1edcp-5, 0x0.0p+0}};
  static constexpr double kAV[7][7] = {{},
      {0x1.a41a41a41a41ap-3},
      {0x1.3b13b13b13b14p-4, 0x1.d89d89d89d89ep-3},
      {0x1.1184bda12f685p+0, -0x1.05ce38e38e38ep+2, 0x1.ed84bda12f685p+1},
      {0x1.38dff34ed9c50p+1, -0x1.3129625c6fd34p+3, 0x1.05a2c80d40b5cp+3, -0x1.5aa4e27e6d737p-3},
      {0x1.7cc7f285392d1p+1, -0x1.6b826a439f657p+3, 0x1.2ea524bb94f7dp+3, 0x1.4bea57f284bc4p-3, -0x1.e1181e437c255p-3},
      {0x1.7e5f6a217f904p-4, 0x0.0p+0, 0x1.d8ab0e0c6a7edp-2, 0x1.aae330f0fb682p-1, -0x1.3815b64c71aaap-1, 0x1.c444444444444p-3}};
  static constexpr double kB[7] = {0x1.7e5f6a217f904p-4, 0x0.0p+0, 0x1.473b587ebfe1ap-2, 0x1.1c9775f5fcf01p-3, -0x1.a8f77010f1edcp-5, 0x0.0p+0, 0x0.0p+0};
  static constexpr double kBV[7] = {0x1.7e5f6a217f904p-4, 0x0.0p+0, 0x1.d8ab0e0c6a7edp-2, 0x1.aae330f0fb682p-1, -0x1.3815b64c71aaap-1, 0x1.c444444444444p-3, 0x0.0p+0};
  static constexpr double kE[7] = {0x1.95a527828d9b1p-9, 0x0.0p+0, -0x1.e47d1cfce0843p-8, 0x1.4cf28454e5294p-6, -0x1.0687e205febb9p-6, 0x0.0p+0, 0x0.0p+0};
  static constexpr double kEV[7] = {0x1.95a527828d9b1p-9, 0x0.0p+0, -0x1.5de894ef85b4dp-7, 0x1.f36bc67f57bddp-4, -0x1.819793f8ce238p-3, 0x1.d2aa55119176bp-4, -0x1.47ae147ae147bp-5};
};

}  // namespace tableau

// the instances, in the order of eet_fleet_scan's `instance` argument
#define EET_FLEET_TABLEAUX(X) X(CashKarp45) X(DormandPrince54) X(DormandPrince87) X(Fehlberg45) X(Tsitouras75) X(Verner87) X(Verner98) X(Fine45)
